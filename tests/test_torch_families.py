"""The multi-output families of mogptk_tpu_torch (uMOSM, CSM, CONV, MOHSM
in both psd_safe modes, SM-LMC, MOSK and the independent kernel, their
block engines' packs and plain twins, Exact, ExactIterative and the named
models SM_LMC, CSM, CONV and MOHSM) against mogptk_tpu's, on the CPU in
float64.

Both packages build each kernel from the same numpy parameters and data
(3 channels of 36, 40 and 44 points, D = 1, and a D = 2 case per family);
the JAX model's raws are carried across with load_raw_state, which checks
the parameter names. The JAX package runs its dense jnp formulations there
(Pallas is off on the CPU; its tests/test_block_families.py holds its
block engines to them), so no interpret mode runs here; the port runs its
block engines' plain twins, whose backward twins compute the hand-derived
element derivatives that csrc/family_element.cuh transcribes. The twins'
pack cotangents differ from the JAX package's by design (the antisymmetric
scalars of a diagonal pair), so the tests compare the parameters'
gradients. The probe-trace LML uses the JAX package's own probes,
rademacher(PRNGKey(seed), (n, R)). Each case's JAX answers are computed
once per test run under one jit without XLA's backend optimizations
(tests/jax_reference.py). rtol 1e-7 (XLA-CPU's exp is only ~1e-8 accurate
even in float64); each atol is stated against the output's scale.
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
import mogptk_tpu.ops.block_families as jbf
import mogptk_tpu_torch as T
import mogptk_tpu_torch.gpr as tgpr
from mogptk_tpu_torch.ops import block_families as tbf
from mogptk_tpu_torch.ops.block_mosm import channel_ids

import jax_reference

RTOL = 1e-7
COUNTS = (36, 40, 44)
PROBES, SEED, LR, STEPS = 8, 3, 0.01, 2
ITER = dict(variance=0.1, max_cg_iters=80, cg_tol=1e-10, num_probes=4, lanczos_iters=8,
            precond_rank=24)
BLOCK = ["umosm", "csm", "conv", "mohsm", "mohsm_safe", "lmc_sm"]
FAMILIES = BLOCK + ["mosk"]
KERNELS = FAMILIES + ["independent"]
CASES = [(name, 1) for name in KERNELS] + [(name, 2) for name in BLOCK]


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


def _kernel(g, name, D):
    """The case's kernel in package g (jgpr or tgpr), its parameters drawn
    from one numpy RandomState."""
    rng = np.random.RandomState(11 + D)
    O = len(COUNTS)
    if name == "umosm":
        k = g.UncoupledMultiOutputSpectralKernel(O, D)
        k.weight.assign(np.tril(0.3 + rng.rand(O, O)))
    elif name == "csm":
        k = g.CrossSpectralKernel(O, D, Rq=2)
        k.amplitude.assign(0.3 + rng.rand(O, 2))
        k.mean.assign(0.1 + 0.4 * rng.rand(D))
        k.variance.assign(0.2 + 0.5 * rng.rand(D))
        k.shift.assign(0.5 * rng.randn(O, 2))
        return k
    elif name == "conv":
        k = g.GaussianConvolutionProcessKernel(O, D)
        k.weight.assign(0.5 + rng.rand(O))
        k.variance.assign(0.1 + rng.rand(O, D))
        k.base_variance.assign(0.2 + rng.rand(D))
        return k
    elif name in ("mohsm", "mohsm_safe"):
        k = g.MultiOutputHarmonizableSpectralKernel(O, D, psd_safe=name == "mohsm_safe")
        # MOHSM's cross-channel blocks are indefinite for wide envelopes
        # (ROADMAP queue 3, caveats): narrow ones keep K + 0.1 I positive
        k.weight.assign(0.5 + rng.rand(O))
        k.lengthscale.assign(0.1 + 0.1 * rng.rand(O))
        k.center.assign(5.0 * rng.rand(D))
        k.mean.assign(0.1 + 0.4 * rng.rand(O, D))
        k.variance.assign(1.0 + rng.rand(O, D))
        k.delay.assign(0.2 * rng.randn(O, D))
        k.phase.assign(0.5 * rng.randn(O))
        return k
    elif name == "lmc_sm":
        k = g.LinearModelOfCoregionalizationKernel([g.SpectralKernel(D) for _ in range(2)],
                                                   output_dims=O, input_dims=D, Q=2, Rq=2)
        k.weight.assign(0.2 + rng.rand(O, 2, 2))
        for q in range(2):
            k[q].magnitude.assign(0.5 + rng.rand())
            k[q].mean.assign(0.1 + 0.4 * rng.rand(D))
            k[q].variance.assign(0.2 + 0.5 * rng.rand(D))
        return k
    elif name == "mosk":
        k = g.MultiOutputSpectralKernel(O, D)
        k.weight.assign(0.5 + rng.rand(O))
    else:
        k = g.IndependentMultiOutputKernel(*[g.SpectralKernel(D) for _ in range(O)])
        for i in range(O):
            k[i].magnitude.assign(0.5 + rng.rand())
            k[i].mean.assign(0.1 + 0.4 * rng.rand(D))
            k[i].variance.assign(0.2 + 0.5 * rng.rand(D))
        return k
    k.mean.assign(0.1 + 0.4 * rng.rand(O, D))
    k.variance.assign(0.3 + 0.5 * rng.rand(O, D))
    k.delay.assign(0.2 * rng.randn(O, D))
    k.phase.assign(0.5 * rng.randn(O))
    return k


def _data(D):
    """Channel-sorted X (N, 1 + D) with COUNTS points per channel, y (N, 1),
    query points Xq (every fifth point moved by 0.37) and the cotangents of
    the twin checks."""
    rng = np.random.RandomState(D)
    X = np.concatenate([np.concatenate([np.full((n, 1), float(i)), rng.rand(n, D) * 10], axis=1)
                        for i, n in enumerate(COUNTS)])
    y = np.sin(1.3 * X[:, 1:2] + X[:, :1]) + 0.05 * rng.randn(X.shape[0], 1)
    Xq = X[::5].copy()
    Xq[:, 1:] += 0.37
    N = X.shape[0]
    return dict(X=X, y=y, Xq=Xq, G=rng.randn(N, N), A=rng.randn(N, 3), B=rng.randn(N, 3),
                V=rng.randn(N, 2))


def _probes(n):
    return np.asarray(jax.random.rademacher(jax.random.PRNGKey(SEED), (n, PROBES),
                                            dtype=jnp.float64))


def _iter_draws(n):
    k0, k1 = jax.random.split(jax.random.PRNGKey(0))
    return (np.asarray(jax.random.rademacher(jax.random.PRNGKey(1), (n, ITER["num_probes"]),
                                             dtype=jnp.float64)),
            (np.asarray(jax.random.normal(k0, (n, ITER["num_probes"]), dtype=jnp.float64)),
             np.asarray(jax.random.normal(k1, (ITER["precond_rank"], ITER["num_probes"]),
                                          dtype=jnp.float64))))


def _jax_case(name, D):
    """Every JAX answer of one case under one jit: the Gram and the cross
    Gram, the block family's pack, K·V and the raws' gradients of Σ K∘G and
    Σ K∘(ABᵀ), the closed-form and probe-trace losses and gradients, and
    for D = 1 predict_f (diagonal and full) and the iterative first step."""
    d = _data(D)
    X, y = d["X"], d["y"]
    cf = jgpr.Exact(_kernel(jgpr, name, D), X, y, variance=0.1)
    pt = jgpr.Exact(_kernel(jgpr, name, D), X, y, variance=0.1, trace_probes=PROBES, seed=SEED)
    it = jgpr.ExactIterative(_kernel(jgpr, name, D), X, y, **ITER) if (
        D == 1 and name in FAMILIES) else None
    models = [m for m in (cf, pt, it) if m is not None]
    splits = [m._split_raws() for m in models]
    family = None
    if name in BLOCK:
        family = jgpr.iterative._family_of(cf.kernel)

    def run(splits, Xq, G, A, B, V):
        out = {}
        loss_grads = [jax.value_and_grad(m.make_loss_fn())(*s) for m, s in zip(models, splits)]
        out["cf"], out["pt"] = loss_grads[:2]
        if it is not None:
            out["iter"] = loss_grads[2]
        train, fixed = splits[0]

        def gram(tr):
            with cf.bind(cf._merge_raws(tr, fixed)):
                return cf.kernel.K(X)

        K = gram(train)
        out["K"], out["KV"] = K, K @ V
        out["Kq"] = cf.kernel.K(X, Xq)
        out["dG"] = jax.grad(lambda tr: jnp.sum(gram(tr) * G))(train)
        out["dAB"] = jax.grad(lambda tr: jnp.sum(gram(tr) * (A @ B.T)))(train)
        if family is not None:
            out["pack"] = jbf._resolve(*family)[0](jgpr.iterative._fused_kernel_params(cf.kernel))
        if D == 1:
            out["predict"] = cf.predict_f(Xq)
            out["predict_full"] = cf.predict_f(Xq, full=True)
        return out

    jgpr.use_pallas(False)
    try:
        out = jax_reference.jit(run)(splits, d["Xq"], d["G"], d["A"], d["B"], d["V"])
    finally:
        jgpr.use_pallas(None)
    out = jax.tree_util.tree_map(np.asarray, out)
    out["models"] = [jax_reference.raws_and_names(m) for m in models]
    return out


_ANSWERS = {}


@pytest.fixture(scope="module")
def jax_answers(tmp_path_factory):
    """case -> its JAX answers, each case once per test run, whichever
    worker asks first (jax_reference.once_per_run)."""
    def get(name, D):
        if (name, D) not in _ANSWERS:
            _ANSWERS[(name, D)] = jax_reference.once_per_run(
                tmp_path_factory, "families_jax_%s_%d" % (name, D), lambda: _jax_case(name, D))
        return _ANSWERS[(name, D)]
    return get


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, what, atol_rel=1e-12):
    """rtol 1e-7, atol `atol_rel` of the reference's largest entry."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-300)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=atol_rel * scale,
                               err_msg=what)


def _grads_close(got, want, what):
    """Gradients: rtol 1e-7, atol 1e-9 of the largest entry (entries that
    cancel to ~0 carry the summation noise of the largest)."""
    assert len(got) == len(want), what
    scale = max(float(np.abs(w).max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g), w, rtol=RTOL, atol=1e-9 * scale,
                                   err_msg="%s %d" % (what, i))


def _port(answers, which, **kw):
    """The port's model `which` (0 closed-form Exact, 1 probe-trace Exact,
    2 ExactIterative) of the case, with the JAX model's raws."""
    name, D = answers["case"]
    d = _data(D)
    k = _kernel(tgpr, name, D)
    if which == 2:
        Z, normals = _iter_draws(d["X"].shape[0])
        m = tgpr.ExactIterative(k, d["X"], d["y"], probes=Z, p_normals=normals, **ITER)
    elif which == 1:
        m = tgpr.Exact(k, d["X"], d["y"], variance=0.1, probes=_probes(d["X"].shape[0]))
    else:
        m = tgpr.Exact(k, d["X"], d["y"], variance=0.1)
    src = answers["models"][which]
    tgpr.load_raw_state(m, src["raws"], names=src["names"])
    return m


@pytest.fixture
def case(request, jax_answers):
    name, D = request.param
    out = dict(jax_answers(name, D))
    out["case"] = (name, D)
    return out


def _ids(cases):
    return ["%s-D%d" % c for c in cases]


def _loss_and_grads(m):
    raws = m.trainable_raws()
    for r in raws:
        r.grad = None
    val = m.loss()
    val.backward()
    assert bool(torch.isfinite(val))
    return float(val.detach()), [r.grad.numpy() for r in raws]


# -- the Grams, the packs and the twins ----------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_ids(CASES), indirect=True)
def test_gram_and_cross_gram_match_jax(case):
    """K(X) (channel-sorted: the block engine's plain twin K-fam-gram, or
    the MOSM one) and K(X, Xq) (the dense formulations); atol 1e-12 of
    max|K|."""
    m = _port(case, 0)
    with torch.no_grad():
        K = m._Kff()
        _close(K.numpy(), case["K"], "K")
        _close(m.kernel.K(m.X, _t(_data(case["case"][1])["Xq"])).numpy(), case["Kq"], "Kq")
        assert (m._channel_counts == COUNTS) == hasattr(m.kernel, "K_sorted")


FAMILY_CASES = [c for c in CASES if c[0] in FAMILIES]


def _pack_parts(m):
    """(family, x, c, params as leaves needing grad, the pack from them)."""
    family = tgpr.iterative._family_of(m.kernel)
    _, x = m.kernel._split(m.X)
    c = channel_ids(COUNTS, x.device)
    return family, x, c, tbf.pack_of(family, tgpr.iterative._fused_kernel_params(m.kernel))


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in BLOCK],
                         ids=_ids([c for c in CASES if c[0] in BLOCK]), indirect=True)
def test_pack_matches_jax(case):
    """The (O, O, S) pack in the JAX package's scalar order; atol 1e-12."""
    m = _port(case, 0)
    with torch.no_grad():
        _, _, _, pack = _pack_parts(m)
    _close(pack[0].numpy(), case["pack"], "pack")


@pytest.mark.parametrize("case", FAMILY_CASES, ids=_ids(FAMILY_CASES), indirect=True)
def test_twins_match_jax(case):
    """The four plain twins: K-fam-gram's (all pairs from their own
    scalars) against the JAX Gram; K-fam-matvec's K·V; K-fam-gram-bwd's
    pack cotangent for a dense G and K-fam-lowrank-vjp's for dK = ABᵀ,
    each chained through the pack to the raws and held against the JAX
    raws' gradients of Σ K∘G and Σ K∘(ABᵀ) (atol 1e-9 of the largest)."""
    m = _port(case, 0)
    family, x, c, pack = _pack_parts(m)
    raws = m.kernel.trainable_raws()
    d = _data(case["case"][1])
    with torch.no_grad():
        det = tuple(p.detach() for p in pack)
        _close(tbf.gram_of(family, x, c, x, c, det).numpy(), case["K"], "gram twin")
        _close(tbf.matvec_of(family, x, c, det, _t(d["V"])).numpy(), case["KV"], "matvec twin")
        dlow = tbf.lowrank_vjp_of(family, x, COUNTS, det, _t(d["A"]), _t(d["B"]))
        if family[0] != "mosm":
            dG = tbf.family_gram_bwd(family, x, c, x, c, det[0], _t(d["G"]))
    n_kernel = len(raws)
    want = [g for g in case["dG"]][:n_kernel]
    if family[0] != "mosm":
        got = torch.autograd.grad(pack, raws, (dG,), retain_graph=True)
        _grads_close([g.numpy() for g in got], want, "gram-bwd twin")
    got = torch.autograd.grad(pack, raws, dlow)
    _grads_close([g.numpy() for g in got], [g for g in case["dAB"]][:n_kernel], "lowrank twin")


@pytest.mark.parametrize("name", ["umosm", "csm", "conv", "mohsm", "lmc_sm"])
def test_pair_swap_mirrors_the_gram(name):
    """The identity K-fam-gram's square launch rests on when it writes each
    lower tile's transpose as the upper one: K(x1, x2; c1, c2) =
    K(x2, x1; c2, c1)ᵀ, the pack's antisymmetric scalars (Δθ, Δφ, CSM's
    shift) flipping sign with τ. Pure torch, float64, the plain twin on
    random points and channel IDs at D = 1 and 2; rtol 1e-12 of max|K|."""
    rng = np.random.RandomState(31)
    O = len(COUNTS)
    for D in (1, 2):
        k = _kernel(tgpr, name, D)
        with torch.no_grad():
            pack = tbf.family_pack(k.family, k._fused_params())
        x1, x2 = _t(rng.rand(57, D) * 10), _t(rng.rand(43, D) * 10)
        c1, c2 = (torch.as_tensor(rng.randint(0, O, m), dtype=torch.int32) for m in (57, 43))
        K = tbf.family_gram_plain(k.family, x1, c1, x2, c2, pack)
        Kt = tbf.family_gram_plain(k.family, x2, c2, x1, c1, pack)
        assert K.dtype == torch.float64 and K.shape == (57, 43)
        torch.testing.assert_close(K, Kt.T, rtol=0, atol=1e-12 * float(K.abs().max()))


# -- Exact: closed form, probe trace, predict ----------------------------------

@pytest.mark.parametrize("case", CASES, ids=_ids(CASES), indirect=True)
def test_closed_form_lml_and_gradients_match_jax(case):
    """Exact(trace_probes=None): the LML (rtol 1e-7) and the raws'
    gradients through the Gram's backward twin (K-fam-gram-bwd's on sorted
    data for the block families)."""
    loss, grads = _loss_and_grads(_port(case, 0))
    np.testing.assert_allclose(loss, float(case["cf"][0]), rtol=RTOL)
    _grads_close(grads, case["cf"][1], "closed-form gradient")


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES), indirect=True)
def test_probe_trace_lml_and_gradients_match_jax(case):
    """Exact(probes=Z) with the JAX package's Z: for the block families on
    channel-sorted data the fused LML (ops/linalg.LmlCholFused through the
    low-rank VJP twin), for the independent kernel the dense estimator."""
    m = _port(case, 1)
    assert (m._fused_static() is not None) == (case["case"][0] in FAMILIES)
    loss, grads = _loss_and_grads(m)
    np.testing.assert_allclose(loss, float(case["pt"][0]), rtol=RTOL)
    _grads_close(grads, case["pt"][1], "probe-trace gradient")


D1 = [c for c in CASES if c[1] == 1]


@pytest.mark.parametrize("case", D1, ids=_ids(D1), indirect=True)
def test_predict_f_matches_jax(case):
    """predict_f's mean and variance, and with full=True the covariance;
    atol 1e-10 of each output's scale (two triangular solves)."""
    m = _port(case, 0)
    Xq = _t(_data(1)["Xq"])
    for full, key in ((False, "predict"), (True, "predict_full")):
        mu, var = m.predict_f(Xq, full=full)
        _close(mu.numpy(), case[key][0], key + " mean", 1e-10)
        _close(var.numpy(), case[key][1], key + " variance", 1e-10)


ITER_CASES = [c for c in D1 if c[0] in FAMILIES]


@pytest.mark.parametrize("case", ITER_CASES, ids=_ids(ITER_CASES), indirect=True)
def test_iterative_first_step_matches_jax(case):
    """ExactIterative with the JAX package's draws: the training-path
    estimate and its gradient through the family's matvec, pivot-row and
    low-rank VJP twins."""
    loss, grads = _loss_and_grads(_port(case, 2))
    np.testing.assert_allclose(loss, float(case["iter"][0]), rtol=RTOL)
    _grads_close(grads, case["iter"][1], "iterative gradient")


def test_iterative_rejects_a_kernel_without_a_block_engine():
    """As the JAX package's _family_of: ValueError."""
    d = _data(1)
    for k in (_kernel(tgpr, "independent", 1),
              tgpr.LinearModelOfCoregionalizationKernel(
                  [tgpr.SpectralKernel(1), tgpr.SpectralKernel(1) * tgpr.SpectralKernel(1)],
                  output_dims=3, Q=2)):
        with pytest.raises(ValueError, match="use Exact for other kernels"):
            tgpr.ExactIterative(k, d["X"], d["y"], **ITER)


def test_compositors_flatten_and_sum():
    """AddKernel flattens a nested sum, MulKernel a nested product, a
    MixtureKernel holds Q clones; K is the sum (product) of the children."""
    s = [tgpr.SpectralKernel() for _ in range(3)]
    add = s[0] + (s[1] + s[2])
    assert isinstance(add, tgpr.AddKernel) and len(add.kernels) == 3
    mul = s[0] * (s[1] * s[2])
    assert isinstance(mul, tgpr.MulKernel) and len(mul.kernels) == 3
    X = torch.linspace(0.0, 3.0, 7, dtype=torch.float64).reshape(-1, 1)
    Ks = [k.K(X) for k in s]
    torch.testing.assert_close(add.K(X), Ks[0] + Ks[1] + Ks[2])
    torch.testing.assert_close(mul.K(X), Ks[0] * Ks[1] * Ks[2])
    mix = tgpr.MixtureKernel(tgpr.CrossSpectralKernel(2), 3)
    assert len(mix.kernels) == 3 and mix.kernels[0] is not mix.kernels[1]
    assert tgpr.parameter_names(mix)[:2] == ["MixtureKernel[0].CrossSpectralKernel.amplitude",
                                             "MixtureKernel[0].CrossSpectralKernel.mean"]


# -- the named models ----------------------------------------------------------

MODELS = ["SM_LMC", "CSM", "CONV", "MOHSM"]


def _named(pkg, which):
    """`which` on 3 channels of 30 points (20% removed by the package's
    seeded Generator), its parameters after construction and after
    init_parameters('LS')."""
    pkg.set_seed(5)
    rng = np.random.RandomState(0)
    t = np.linspace(0.0, 10.0, 30)
    ds = pkg.DataSet([t] * 3, [np.sin(1.3 * t + i) + 0.1 * rng.randn(30) for i in range(3)],
                     names=["ch%d" % i for i in range(3)])
    for ch in ds:
        ch.remove_randomly(pct=0.2)
    model = {"SM_LMC": lambda: pkg.SM_LMC(ds, Q=2, Rq=2), "CSM": lambda: pkg.CSM(ds, Q=2, Rq=2),
             "CONV": lambda: pkg.CONV(ds, Q=2),
             "MOHSM": lambda: pkg.MOHSM(ds, P=1, Q=2, psd_safe=True)}[which]()
    params = lambda: ([np.asarray(p()) for p in model.gpr.parameters()] if pkg is J
                      else [p.numpy() for p in model.parameters()])
    out = dict(init=params())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model.init_parameters("LS")
    out["ls"] = params()
    return out, model


def _jax_named(which):
    """The JAX model's parameters, raws and names, and two optax Adam steps
    of its gpr model (the update of gpr/training.py) under one jit."""
    out, model = _named(J, which)
    jm = model.gpr
    out.update(jax_reference.raws_and_names(jm))
    train, fixed = jm._split_raws()
    vg = jax_reference.jit(jax.value_and_grad(jm.make_loss_fn()))
    opt = optax.adam(LR)
    state = opt.init(train)
    out["losses"] = []
    for _ in range(STEPS):
        v, g = vg(train, fixed)
        out["losses"].append(float(v))
        upd, state = opt.update(g, state, train)
        train = optax.apply_updates(train, upd)
    out["trained"] = [np.asarray(a) for a in train]
    return out


@pytest.fixture
def named(request, tmp_path_factory):
    which = request.param
    return (jax_reference.once_per_run(tmp_path_factory, "families_jax_named_" + which,
                                       lambda: _jax_named(which)), which)


@pytest.mark.parametrize("named", MODELS, indirect=True)
def test_named_model_initial_parameters_match_jax(named):
    """The constructor's draws from the seeded numpy Generator, the bounds
    and the LS initialization; parameter names as the JAX package's."""
    j, which = named
    t, model = _named(T, which)
    for stage in ("init", "ls"):
        assert len(t[stage]) == len(j[stage])
        for i, (a, b) in enumerate(zip(t[stage], j[stage])):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-12 * max(np.abs(b).max(), 1.0),
                                       err_msg="%s %d" % (stage, i))
    assert tgpr.parameter_names(model.gpr) == j["names"]


@pytest.mark.parametrize("named", MODELS, indirect=True)
def test_named_model_trains_like_jax(named):
    """Model.train(Adam, lr=0.01, iters=2) from the JAX model's raws: each
    step's loss (rtol 1e-7) and the trained raws (atol 1e-9 of each raw's
    scale); then predict and error run, and CONV's default
    init_parameters() gives finite parameters."""
    j, which = named
    _, model = _named(T, which)
    tgpr.load_raw_state(model, j["raws"], names=j["names"])
    losses, _ = model.train(method="Adam", lr=LR, iters=STEPS)
    np.testing.assert_allclose(losses[1:], j["losses"], rtol=RTOL)
    trained = [r.detach().numpy() for r in model.gpr.trainable_raws()]
    for i, (a, b) in enumerate(zip(trained, j["trained"])):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-9 * max(np.abs(b).max(), 1.0),
                                   err_msg="raw %d" % i)
    _, mu, lo, up = model.predict()
    assert all(np.all(np.isfinite(m)) for m in mu)
    assert np.isfinite(model.error("MAE"))
    if which == "CONV":
        # its default method, 'SM': an SM model pre-fitted on each channel
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model.init_parameters(iters=3)
        assert all(np.all(np.isfinite(p.numpy())) for p in model.parameters())
