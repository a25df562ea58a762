"""The likelihoods of mogptk_tpu_torch against mogptk_tpu, on the CPU in
float64: the twelve likelihoods and a MultiOutputLikelihood (log density,
variational expectation by quadrature and in closed form, conditional mean,
predictive mean), OpperArchambeau, SparseHensman and Hensman with
non-Gaussian likelihoods (objective, every raw gradient, one Adam step,
predict_f), and the Monte Carlo bands and samplers, held statistically.

Both packages build each likelihood and model on the same numpy data; the
JAX side's raw parameters are carried across with load_raw_state, which
checks the parameter names. Each test loops over its cases and names the
failing one. The JAX answers are computed once per test run
(tests/jax_reference.py), under one jit without XLA's backend
optimizations per group. rtol 1e-7 (XLA-CPU's exp is only ~1e-8 accurate
even in float64); each atol is stated. The draws cannot match jax.random's
bits: seeded torch.Generators make them reproducible, and each statistical
check allows five Monte Carlo standard errors.
"""
import math

import numpy as np
import pytest
import jax
import optax
import torch

import mogptk_tpu as jmogptk
import mogptk_tpu.gpr as jgpr
import mogptk_tpu_torch as tmogptk
import mogptk_tpu_torch.gpr as tgpr

import jax_reference

RTOL = 1e-7
LR = 0.01


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


def _mismatches(label, got, want, out, atol=1e-10):
    """Append to `out` the label of each array of `got` off its twin in
    `want` (rtol 1e-7, atol `atol` of the array's scale, at least 1)."""
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
        a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
        if a.shape != b.shape:
            out.append("%s[%d]: shape %s != %s" % (label, i, a.shape, b.shape))
        elif not np.allclose(a, b, rtol=RTOL, atol=atol * max(np.abs(b).max(initial=0.0), 1.0)):
            out.append("%s[%d]: max|diff| %.3e" % (label, i, np.abs(a - b).max()))
    if len(got) != len(want):
        out.append("%s: %d arrays != %d" % (label, len(got), len(want)))


# -- (a) each likelihood and a MultiOutputLikelihood --------------------------

CHANNELS, PER = 4, 3


def _support(kind, g):
    """Map a signal g into the support of a likelihood family."""
    return {"real": g, "positive": np.exp(g) + 0.1, "counts": np.round(np.exp(g)),
            "binary": (g > 0).astype(np.float64),
            "unit": 0.9 / (1.0 + np.exp(-g)) + 0.05}[kind]


# name: (class, keyword arguments (a link by its name), the support of y)
LIKELIHOODS = {
    "gaussian": ("GaussianLikelihood", dict(scale=0.6), "real"),
    "gaussian_per_channel": ("GaussianLikelihood", dict(scale=[0.3, 0.6, 0.9, 1.2]), "real"),
    "studentt": ("StudentTLikelihood", dict(dof=4, scale=0.7), "real"),
    "exponential": ("ExponentialLikelihood", {}, "positive"),
    "exponential_square": ("ExponentialLikelihood", dict(link="square"), "positive"),
    "laplace": ("LaplaceLikelihood", dict(scale=0.8), "real"),
    "bernoulli": ("BernoulliLikelihood", {}, "binary"),
    "bernoulli_sigmoid": ("BernoulliLikelihood", dict(link="sigmoid"), "binary"),
    "beta": ("BetaLikelihood", dict(scale=2.5), "unit"),
    "gamma": ("GammaLikelihood", dict(shape=1.6), "positive"),
    "gamma_square": ("GammaLikelihood", dict(shape=1.6, link="square"), "positive"),
    "poisson": ("PoissonLikelihood", {}, "counts"),
    "poisson_square": ("PoissonLikelihood", dict(link="square"), "counts"),
    "weibull": ("WeibullLikelihood", dict(shape=1.4), "positive"),
    "loglogistic": ("LogLogisticLikelihood", dict(shape=3.0), "positive"),
    "loggaussian": ("LogGaussianLikelihood", dict(scale=0.5), "positive"),
    "chisquared": ("ChiSquaredLikelihood", {}, "positive"),
}
# the multi-output case: one likelihood (and support) per channel
MULTI = ("studentt", "poisson", "bernoulli", "gamma")


def _likelihood(gpr, name):
    cls, kwargs, _ = LIKELIHOODS[name]
    kwargs = {k: getattr(gpr, v) if k == "link" else v for k, v in kwargs.items()}
    return getattr(gpr, cls)(**kwargs)


def _likelihood_cases(gpr):
    """[(case, likelihood, y)] over the same X: every entry of LIKELIHOODS
    and the 4-channel MultiOutputLikelihood."""
    rng = np.random.RandomState(3)
    g = rng.randn(CHANNELS * PER, 1)
    cases = [(name, _likelihood(gpr, name), _support(LIKELIHOODS[name][2], g))
             for name in LIKELIHOODS]
    c = np.repeat(np.arange(CHANNELS), PER)
    y = np.concatenate([_support(LIKELIHOODS[MULTI[j]][2], g[c == j]) for j in range(CHANNELS)])
    cases.append(("multi", gpr.MultiOutputLikelihood(*[_likelihood(gpr, n) for n in MULTI]), y))
    return cases


def _likelihood_inputs():
    """X with channel IDs, f (N, 6), mu and var (N, 1)."""
    rng = np.random.RandomState(4)
    n = CHANNELS * PER
    X = np.stack([np.repeat(np.arange(CHANNELS, dtype=np.float64), PER), rng.rand(n)], axis=1)
    return X, 0.8 * rng.randn(n, 6), 0.5 * rng.randn(n, 1), 0.05 + 0.4 * rng.rand(n, 1)


def _likelihood_values(lik, X, y, f, mu, var):
    """log_prob, variational_expectation, conditional_mean and the predict
    mean; Bernoulli's probit predict with ci too."""
    out = [lik.log_prob(X, y, f), lik.variational_expectation(X, y, mu, var),
           lik.conditional_mean(X, f), lik.predict(X, mu, var)]
    if type(lik).__name__ == "BernoulliLikelihood":
        out.extend(lik.predict(X, mu, var, ci=[0.025, 0.975]))
    return out


def _jax_likelihoods():
    X, f, mu, var = _likelihood_inputs()
    cases = _likelihood_cases(jgpr)

    def answers(X, f, mu, var):
        return [_likelihood_values(lik, X, y, f, mu, var) for _, lik, y in cases]

    values = jax_reference.jit(answers)(X, f, mu, var)
    return dict(values=[[np.asarray(v) for v in case] for case in values],
                raws=[jax_reference.raws_and_names(lik) for _, lik, _ in cases])


def test_likelihoods_match_jax(tmp_path_factory):
    """Every likelihood (the closed-form variational expectations of
    Gaussian, Exponential, Gamma and Poisson, the quadrature of the others
    and of those with another link) and a 4-channel MultiOutputLikelihood
    (quadrature for each channel): log_prob, variational_expectation,
    conditional_mean and the predict mean, and Bernoulli's probit bands;
    rtol 1e-7, atol 1e-10 of each output's scale. The parameters carry over
    under the JAX names."""
    ans = jax_reference.once_per_run(tmp_path_factory, "likelihood_jax_values", _jax_likelihoods)
    X, f, mu, var = (torch.as_tensor(a) for a in _likelihood_inputs())
    bad = []
    for (name, lik, y), want, raws in zip(_likelihood_cases(tgpr), ans["values"], ans["raws"]):
        tgpr.load_raw_state(lik, raws["raws"], names=raws["names"])
        got = _likelihood_values(lik, X, torch.as_tensor(y), f, mu, var)
        _mismatches(name, got, want, bad)
    assert not bad, bad


# -- (b) the variational models with non-Gaussian likelihoods -----------------

def _model_data(counts):
    """Channel-sorted X, the signal g (N, 1) and MOSM means and variances."""
    rng = np.random.RandomState(5)
    xs = [np.sort(rng.rand(n, 1) * 6, axis=0) for n in counts]
    g = np.concatenate([np.sin(1.3 * x + i) + 0.1 * x + 0.05 * rng.randn(len(x), 1)
                        for i, x in enumerate(xs)])
    X = np.concatenate([np.concatenate([np.full((len(x), 1), float(i)), x], axis=1)
                        for i, x in enumerate(xs)])
    rk = np.random.RandomState(1)
    O = len(counts)
    return X, g, 0.05 + 0.3 * rk.rand(O, 2, 1), 0.2 + 0.3 * rk.rand(O, 2, 1)


# name: (channel counts, one likelihood name per channel or one for all,
# constructor(gpr, kernel, X, y, likelihood))
MODELS = {
    "sparse_hensman_studentt": ((24, 20, 16), "studentt",
                                lambda g, k, X, y, lik: g.SparseHensman(k, X, y, Z=8,
                                                                        likelihood=lik)),
    "sparse_hensman_mix": ((24, 20, 16), ("poisson", "bernoulli", "gamma"),
                           lambda g, k, X, y, lik: g.SparseHensman(k, X, y, Z=8, likelihood=lik)),
    "hensman_beta": ((10, 8, 6), "beta",
                     lambda g, k, X, y, lik: g.Hensman(k, X, y, likelihood=lik)),
    "opper_archambeau_poisson": ((10, 8, 6), "poisson",
                                 lambda g, k, X, y, lik: g.OpperArchambeau(k, X, y,
                                                                           likelihood=lik)),
}


def _build_model(gpr, name):
    """The model on data in its likelihood's support, with the variational
    parameters away from their initial values."""
    counts, liks, make = MODELS[name]
    X, g, mean, var = _model_data(counts)
    c = X[:, 0].astype(int)
    if isinstance(liks, str):
        lik = _likelihood(gpr, liks)
        y = _support(LIKELIHOODS[liks][2], g)
    else:
        lik = gpr.MultiOutputLikelihood(*[_likelihood(gpr, n) for n in liks])
        y = np.concatenate([_support(LIKELIHOODS[n][2], g[c == j]) for j, n in enumerate(liks)])
    k = gpr.MultiOutputSpectralMixtureKernel(2, output_dims=len(counts))
    k.mean.assign(mean)
    k.variance.assign(var)
    m = make(gpr, k, X, y, lik)
    rng = np.random.RandomState(6)
    if hasattr(m, "q_sqrt"):
        n = m.q_mu.shape[0]
        m.q_mu.assign(0.3 * rng.randn(n, 1))
        m.q_sqrt.assign(np.eye(n) + 0.1 * np.tril(rng.randn(n, n), -1))
    else:
        n = m.q_nu.shape[0]
        m.q_nu.assign(0.1 * rng.randn(n, 1))
        m.q_lambda.assign(0.5 + rng.rand(n, 1))
    return m, X


def _jax_model(name):
    """The loss and gradient, the raws after one optax Adam step and
    predict_f at every third training point with and without full."""
    jm, X = _build_model(jgpr, name)
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


def test_nongaussian_models_match_jax(tmp_path_factory):
    """SparseHensman (8 grid inducing points per channel) with Student's t
    and with a Poisson/Bernoulli/Gamma MultiOutputLikelihood, Hensman with
    Beta and OpperArchambeau with Poisson, on a 3-channel MOSM: loss() and
    every trainable raw's gradient (rtol 1e-7, atol 1e-9 of the largest
    entry), one gpr.train Adam step against optax.adam (atol 1e-9 of each
    raw's scale) and predict_f with and without full (atol 1e-9)."""
    bad = []
    for name in MODELS:
        ans = jax_reference.once_per_run(tmp_path_factory, "likelihood_jax_" + name,
                                         lambda: _jax_model(name))
        tm, _ = _build_model(tgpr, name)
        tgpr.load_raw_state(tm, ans["model"]["raws"], names=ans["model"]["names"])
        loss = tm.loss()
        loss.backward()
        _mismatches(name + " loss", [loss], [ans["loss"]], bad)
        scale = max(float(np.abs(g).max()) for g in ans["grads"])
        raws = tm.trainable_raws()
        _mismatches(name + " gradient", [r.grad for r in raws], ans["grads"], bad,
                    atol=1e-9 * scale)
        if not all(bool(torch.isfinite(r.grad).all()) for r in raws):
            bad.append(name + ": a gradient is not finite")
        for r in raws:
            r.grad = None
        pred = tm.predict_f(ans["Xq"]) + tm.predict_f(ans["Xq"], full=True)
        _mismatches(name + " predict_f", pred, ans["pred"], bad, atol=1e-9)
        tgpr.train(tm, method="Adam", lr=LR, iters=1)
        _mismatches(name + " Adam step", tm.trainable_raws(), ans["stepped"], bad, atol=1e-9)
    assert not bad, bad


# -- (c) the Monte Carlo bands and the samplers ---------------------------------

# sampling likelihoods: (name, low, high, integer draws)
SAMPLERS = (("gaussian_per_channel", -np.inf, np.inf, False), ("studentt", -np.inf, np.inf, False),
            ("exponential", 0.0, np.inf, False), ("laplace", -np.inf, np.inf, False),
            ("beta", 0.0, 1.0, False), ("gamma", 0.0, np.inf, False),
            ("poisson", 0.0, np.inf, True), ("weibull", 0.0, np.inf, False),
            ("loglogistic", 0.0, np.inf, False), ("loggaussian", 0.0, np.inf, False),
            ("chisquared", 0.0, np.inf, False))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _within(label, got, want, se, out, k=5.0):
    """Append to `out` where |got − want| exceeds k standard errors."""
    err = (got - want).abs() / se
    if not bool((err <= k).all()):
        out.append("%s: %.2f standard errors off" % (label, float(err.max())))


def _check_bands_and_samplers(bad):
    n = CHANNELS * PER
    X, _, _, _ = (torch.as_tensor(a) for a in _likelihood_inputs())
    f = torch.linspace(-1.0, 1.0, n, dtype=torch.float64).reshape(-1, 1)
    S = 20000

    # LogGaussian's bands against its exact quantiles: log y ~ N(mu, var + s²)
    lik = tgpr.LogGaussianLikelihood(scale=0.4)
    mu, var = 0.5 * f, 0.02 + 0.1 * (f + 1.0)
    draws = 10000
    _, lo, up = lik.predict(X, mu, var, ci=[0.025, 0.975], n=draws, generator=_gen(1))
    sd = torch.sqrt(var + 0.4 ** 2)
    z = 1.959963984540054
    se = sd * math.sqrt(0.025 * 0.975 / draws) / (math.exp(-0.5 * z * z) / math.sqrt(2 * math.pi))
    _within("LogGaussian lower band", torch.log(lo), mu - z * sd, se, bad)
    _within("LogGaussian upper band", torch.log(up), mu + z * sd, se, bad)
    again = lik.predict(X, mu, var, ci=[0.025, 0.975], n=draws, generator=_gen(1))
    if not (torch.equal(again[1], lo) and torch.equal(again[2], up)):
        bad.append("LogGaussian bands: a seeded generator did not repeat them")
    _, lo1, up1 = lik.predict(X, mu, var, ci=[0.0, 1.0], n=draws, generator=_gen(2))
    if not bool((lo1 <= lo).all() and (up <= up1).all()):
        bad.append("ci = [0, 1]: the bands are not the extreme draws")

    # each sampler: draws in its support, their mean at conditional_mean
    fs = f.T.expand(S, n)
    for name, low, high, integer in SAMPLERS:
        lik = _likelihood(tgpr, name)
        s = lik.conditional_sample(X, fs, generator=_gen(3))
        if s.shape != (S, n) or not bool(((low <= s) & (s <= high)).all()):
            bad.append("%s: draws of shape %s outside [%s, %s]" % (name, tuple(s.shape), low, high))
        if integer and not torch.equal(s, torch.round(s)):
            bad.append("%s: draws are not integers" % name)
        mean = lik.conditional_mean(X, f).reshape(-1)
        _within(name + " draws' mean", s.mean(0), mean, s.std(0) / math.sqrt(S), bad)
    multi = _likelihood_cases(tgpr)[-1][1]
    if multi.conditional_sample(X, fs, generator=_gen(4)) is not None:
        bad.append("a MultiOutputLikelihood with a Bernoulli channel drew y")
    sampling = tgpr.MultiOutputLikelihood(*[_likelihood(tgpr, m) for m in
                                            ("studentt", "poisson", "gamma", "loggaussian")])
    s = sampling.conditional_sample(X, fs, generator=_gen(5))
    mean = sampling.conditional_mean(X, f).reshape(-1)
    _within("MultiOutputLikelihood draws' mean", s.mean(0), mean, s.std(0) / math.sqrt(S), bad)


def _check_sample_f(bad):
    """sample_f's draws against predict_f(full=True) and against the prior."""
    m, X = _build_model(tgpr, "sparse_hensman_mix")
    Xq = torch.as_tensor(X[::9])
    S = 20000
    for prior in (False, True):
        if prior:
            mu, cov = torch.zeros(Xq.shape[0], 1, dtype=torch.float64), m.kernel(Xq).detach()
        else:
            mu, cov = m.predict_f(Xq, full=True)
        s = m.sample_f(Xq, n=S, prior=prior, generator=_gen(6))
        if s.shape != (S, Xq.shape[0]):
            bad.append("sample_f(prior=%s): shape %s" % (prior, tuple(s.shape)))
            continue
        d = torch.diagonal(cov)
        _within("sample_f(prior=%s) mean" % prior, s.mean(0), mu.reshape(-1),
                torch.sqrt(d / S), bad)
        c = torch.cov(s.T)
        _within("sample_f(prior=%s) covariance" % prior, c, cov,
                torch.sqrt((torch.outer(d, d) + cov ** 2) / S), bad)
    one = m.sample_f(Xq, generator=_gen(6))
    if one.shape != (Xq.shape[0],):
        bad.append("sample_f(n=None): shape %s" % (tuple(one.shape),))
    if m.sample_y(Xq, n=2) is not None:
        bad.append("sample_y with a Bernoulli channel drew y")


USER_LIKELIHOODS = ("studentt", "poisson", "gamma")


def _user_model(pkg, likelihood=None):
    """mogptk.MOSM through the Hensman selector (4 inducing points per
    channel) on 3 channels of 12, 10 and 8 points whose y lie in the
    support of Student's t, Poisson and Gamma likelihoods."""
    X, g, _, _ = _model_data((12, 10, 8))
    c = X[:, 0].astype(int)
    xs = [X[c == j, 1] for j in range(3)]
    ys = [_support(LIKELIHOODS[k][2], g[c == j, 0]) for j, k in enumerate(USER_LIKELIHOODS)]
    pkg.gpr.set_seed(3)
    return pkg.MOSM(pkg.DataSet(xs, ys), Q=2,
                    inference=pkg.Hensman(inducing_points=4, likelihood=likelihood))


class _Draws:
    """Stands in for a JAX gpr model under mogptk_tpu.Model.sample: hands
    it the port's draws, so that both packages' sample() split and shape
    the same numbers."""

    def __init__(self, draws):
        self.draws = draws

    def sample_y(self, Z, n=None):
        return self.draws

    def sample_f(self, Z, n=None, prior=False):
        return self.draws


def test_bands_and_samplers(tmp_path_factory):
    """The Monte Carlo bands of LogGaussianLikelihood against its exact
    quantiles, each sampler's draws in their support with their mean at
    conditional_mean, sample_f's mean and covariance at predict_f(full=True)
    and at the prior (all within 5 Monte Carlo standard errors, seeded
    generators); Model.sample's per-channel arrays as the JAX package's
    Model.sample makes them from the same draws, predict with ci = 1.0, and
    save/LoadModel of a model with a MultiOutputLikelihood."""
    bad = []
    _check_bands_and_samplers(bad)
    _check_sample_f(bad)

    tm = _user_model(tmogptk, tgpr.MultiOutputLikelihood(
        *[_likelihood(tgpr, k) for k in USER_LIKELIHOODS]))
    jm = _user_model(jmogptk)
    x = tm._to_kernel_format(tm.dataset.get_prediction_data())
    for n, prior in ((None, False), (3, False), (2, True)):
        tgpr.set_seed(11)
        got = tm.sample(n=n, prior=prior)
        tgpr.set_seed(11)
        draws = tm.gpr.sample_f(x, n=n, prior=True) if prior else tm.gpr.sample_y(x, n=n)
        jm.gpr = _Draws(draws.numpy())
        _mismatches("sample(n=%s, prior=%s)" % (n, prior), got, jm.sample(n=n, prior=prior), bad,
                    atol=0.0)
    tm.train(method="Adam", lr=0.01, iters=1)
    _, mu, lo, up = tm.predict(ci=1.0, n=500)
    for j in range(3):
        if not (np.all(np.isfinite(lo[j])) and np.all(lo[j] <= up[j])):
            bad.append("predict(ci=1.0): channel %d's bands" % j)
    path = str(tmp_path_factory.mktemp("likelihood_save") / "model")
    tm.save(path)
    loaded = tmogptk.LoadModel(path, device="cpu")
    if loaded.gpr.likelihood.name() != tm.gpr.likelihood.name():
        bad.append("LoadModel: likelihood %s" % loaded.gpr.likelihood.name())
    _mismatches("LoadModel raws", loaded.gpr.raw_state(), [r.numpy() for r in tm.gpr.raw_state()],
                bad, atol=0.0)
    _mismatches("LoadModel predict", loaded.predict(n=500)[1], tm.predict(n=500)[1], bad, atol=0.0)
    assert not bad, bad
