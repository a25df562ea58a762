"""The exact-GP training step of mogptk_tpu_torch against mogptk_tpu.

Both packages build Exact(trace_probes=8, seed=3) on the same numpy data in
float64 on the CPU; the JAX model's raws are carried across with
load_raw_state and its probes Z = rademacher(PRNGKey(3), (n, 8)) are handed to
the port through probes=. The JAX side runs its fused LML
(ops/linalg.lml_chol_fused) with the Pallas kernels in interpret mode
(use_pallas(True)); the port runs its kernels' plain twins on CPU tensors.
rtol 1e-7 (XLA-CPU's exp is only ~1e-8 accurate even in float64); each atol
is stated relative to the output's scale. The JAX answers are computed once
per module.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

import mogptk_tpu.gpr as jgpr
import mogptk_tpu_torch.gpr as tgpr
from mogptk_tpu_torch.gpr import lbfgs as tlbfgs
from mogptk_tpu_torch.ops import block_mosm as tbm
from mogptk_tpu_torch.ops import fused_solve as tfs
from mogptk_tpu_torch.ops import blocked_cholesky as tbc

import jax_reference

RTOL = 1e-7
PROBES, SEED, LR, STEPS = 8, 3, 0.01, 3


@pytest.fixture(scope="module", autouse=True)
def cpu_float64():
    """The port runs on the card unless asked: these tests ask for the CPU,
    on one thread (the shapes are small, and the suite runs files in
    parallel processes)."""
    cfg = tgpr.config
    saved = (cfg.device, cfg._dtype, cfg.blocked_cholesky, cfg.blocked_cholesky_block,
             torch.get_num_threads())
    cfg.device = "cpu"
    tgpr.use_double_precision()
    torch.set_num_threads(1)
    yield
    (cfg.device, cfg._dtype, cfg.blocked_cholesky, cfg.blocked_cholesky_block, threads) = saved
    torch.set_num_threads(threads)


def _dense_data():
    """3 channels x 40 points, as tests/test_linalg.py TestLmlCholFused."""
    rng = np.random.RandomState(0)
    xs = [np.sort(rng.rand(40, 1) * 10, axis=0) for _ in range(3)]
    ys = [np.sin(1.3 * x + i) + 0.05 * rng.randn(40, 1) for i, x in enumerate(xs)]
    rk = np.random.RandomState(1)
    return xs, ys, 0.05 + 0.3 * rk.rand(3, 2, 1), 0.2 + 0.3 * rk.rand(3, 2, 1)


def _blocked_data():
    """2 channels x 512 points, as tests/test_linalg.py TestBandLowerGram."""
    rng = np.random.RandomState(5)
    x0 = np.sort(rng.rand(512, 1), axis=0)
    ys = [np.sin(4 * x0) + 0.05 * rng.randn(512, 1), np.cos(4 * x0) + 0.05 * rng.randn(512, 1)]
    return ([x0, x0], ys, 0.05 + 0.3 * np.random.RandomState(6).rand(2, 2, 1),
            0.2 + 0.3 * np.random.RandomState(7).rand(2, 2, 1))


def _jax_model(data):
    xs, ys, mean, var = data
    _, X, Y = jgpr.merge_data(xs, ys)
    k = jgpr.MultiOutputSpectralMixtureKernel(2, output_dims=len(xs))
    k.mean.assign(mean)
    k.variance.assign(var)
    m = jgpr.Exact(k, X, Y, variance=0.1, trace_probes=PROBES, seed=SEED)
    assert m._fused_static() is not None
    Z = np.asarray(jax.random.rademacher(jax.random.PRNGKey(SEED), (X.shape[0], PROBES),
                                         dtype=jnp.float64))
    return m, Z


def _port_model(data, jm, Z, **kw):
    xs, ys, _, _ = data
    _, X, Y = tgpr.merge_data(xs, ys)
    k = tgpr.MultiOutputSpectralMixtureKernel(2, output_dims=len(xs))
    tm = tgpr.Exact(k, X, Y, variance=0.1, probes=Z, **kw)
    tgpr.load_raw_state(tm, jm["raws"], names=jm["names"])
    return tm


def _jax_run(data, steps):
    """Loss and gradient at the start, then the raws after each of `steps`
    optax Adam steps (one jitted value-and-grad, the update of gpr/training.py);
    numpy only, the model as its raws and names (jax_reference.once_per_run)."""
    jgpr.use_pallas(True)
    try:
        jm, Z = _jax_model(data)
        train, fixed = jm._split_raws()
        vg = jax_reference.jit(jax.value_and_grad(jm.make_loss_fn()))
        opt = optax.adam(LR)
        state = opt.init(train)
        losses, grads, raws = [], [], []
        for i in range(steps + 1):
            v, g = vg(train, fixed)
            losses.append(float(v))
            grads.append([np.asarray(a) for a in g])
            if i == steps:
                break
            upd, state = opt.update(g, state, train)
            train = optax.apply_updates(train, upd)
            raws.append([np.asarray(a) for a in train])
    finally:
        jgpr.use_pallas(None)
    return jax_reference.raws_and_names(jm), Z, losses, grads, raws


@pytest.fixture(scope="module")
def jax_dense(tmp_path_factory):
    return jax_reference.once_per_run(tmp_path_factory, "training_jax_dense",
                                      lambda: _jax_run(_dense_data(), STEPS))


def _jax_blocked_run():
    saved = (jgpr.config.blocked_cholesky, jgpr.config.blocked_cholesky_block)
    jgpr.use_blocked_cholesky(True, block_size=512)
    try:
        return _jax_run(_blocked_data(), 0)
    finally:
        jgpr.config.blocked_cholesky, jgpr.config.blocked_cholesky_block = saved
        jgpr.config.bump()


@pytest.fixture(scope="module")
def jax_blocked(tmp_path_factory):
    return jax_reference.once_per_run(tmp_path_factory, "training_jax_blocked", _jax_blocked_run)


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
    names = tgpr.parameter_names(tm)
    assert len(raws) == len(grads)
    for name, r, g in zip(names, raws, grads):
        np.testing.assert_allclose(r.grad.numpy(), g, rtol=RTOL, atol=1e-9 * scale, err_msg=name)


def test_dense_route_loss_and_gradients_match_jax(jax_dense):
    """3 x 40 points: the full sorted Gram, torch.linalg.cholesky and
    torch.cholesky_solve (the blocked path is off below 4096 points on the
    CPU), then the low-rank VJP twin."""
    jm, Z, losses, grads, _ = jax_dense
    tm = _port_model(_dense_data(), jm, Z)
    assert tm._fused_static() == (("mosm", (tm.kernel.twopi, True)), (40, 40, 40), PROBES)
    _check_loss_and_grads(tm, losses[0], grads[0])


def _blocked_route(jax_blocked, monkeypatch, block, fused):
    jm, Z, losses, grads, _ = jax_blocked
    cfg = tgpr.config
    tgpr.use_blocked_cholesky(True, block_size=block)
    cfg.blocked_cholesky_fused_trsm = cfg.pallas_syrk = fused
    calls = []
    names = ["mosm_gram_sorted_lower_plain", "mosm_lowrank_vjp_plain", "blocked_cho_solve"]
    for mod, name in ((tbm, names[0]), (tbm, names[1]), (tfs, names[2]),
                      (tbc, "s_diag_plain"), (tbc, "below_trsm_plain"), (tbc, "col_commit_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    try:
        tm = _port_model(_blocked_data(), jm, Z)
        _check_loss_and_grads(tm, losses[0], grads[0])
    finally:
        tgpr.use_blocked_cholesky(None)
        cfg.blocked_cholesky_fused_trsm = cfg.pallas_syrk = False
    nb = 1024 // block
    if block % tbm.TILE:     # no band-lower Gram at this band: the full Gram
        names.remove("mosm_gram_sorted_lower_plain")
    if fused:      # block columns 1 .. nb-1; rows below all but the last
        names += ["s_diag_plain", "col_commit_plain"] * (nb - 1) + ["below_trsm_plain"] * (nb - 2)
    assert sorted(calls) == sorted(names)


def test_blocked_route_loss_and_gradients_match_jax(jax_blocked, monkeypatch):
    """2 x 512 points with block 512: the band-lower Gram's twin (unwritten
    tiles NaN), the blocked factor with zero_upper=False and every panel
    inverse, the K-solve twin and the K-lowrank-vjp twin."""
    _blocked_route(jax_blocked, monkeypatch, 512, fused=False)


def test_blocked_fused_route_loss_and_gradients_match_jax(jax_blocked, monkeypatch):
    """The same step with gpr.config.blocked_cholesky_fused_trsm and
    pallas_syrk on, against the same JAX answers (block 512 there): block 256
    here, so the factor has four block columns and runs the K-sdiag,
    K-below-trsm and K-commit twins (the float64 answer does not depend on
    the block). The band-lower Gram needs a band its 512-point tile divides,
    so at this band the full Gram is built. K-syrk is not on the
    probe-trace path."""
    _blocked_route(jax_blocked, monkeypatch, 256, fused=True)


def test_three_adam_steps_match_jax(jax_dense):
    """gpr.train(method="Adam", lr=0.01): torch.optim.Adam per raw against
    optax.adam on the same raws and probes; the raws after each step and the
    losses. rtol 1e-7, atol 1e-10 of each raw's scale."""
    jm, Z, losses, _, raws = jax_dense
    tm = _port_model(_dense_data(), jm, Z)
    seen = []
    got_losses, _ = tgpr.train(tm, method="Adam", lr=LR, iters=STEPS,
                               callback=lambda i, v: seen.append(tgpr.raw_state_numpy(tm)))
    np.testing.assert_allclose(got_losses, losses[:STEPS], rtol=RTOL)
    for step, (got, ref) in enumerate(zip(seen, raws)):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-10 * max(np.abs(b).max(), 1.0),
                                       err_msg="step %d" % step)


def _small_model(trace_probes=PROBES, shuffle=False, device=None):
    xs, ys, _, _ = _dense_data()
    _, X, Y = tgpr.merge_data(xs, ys)
    if shuffle:
        perm = np.random.RandomState(0).permutation(X.shape[0])
        X, Y = X[perm], Y[perm]
    k = tgpr.MultiOutputSpectralMixtureKernel(2, output_dims=3)
    return tgpr.Exact(k, X, Y, variance=0.1, trace_probes=trace_probes, device=device)


LBFGS_ITERS = 5


def _tenth(m):
    """The peg's transform: a module-level function, so a model pegged
    through it pickles."""
    return 0.1 * m


class _JaxNormal:
    """A Normal prior for the JAX package: log_prob in jnp arithmetic."""

    def __init__(self, loc, scale):
        self.loc, self.scale = loc, scale

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - np.log(self.scale) - 0.5 * np.log(2.0 * np.pi)


def _jax_rows(jm):
    """The JAX model's print_parameters rows (name, range), read from the
    table it shows inside IPython."""
    import builtins
    import re
    import IPython.display
    shown = []
    saved = IPython.display.display
    builtins.get_ipython = lambda: None
    IPython.display.display = shown.append
    try:
        jm.print_parameters()
    finally:
        IPython.display.display = saved
        del builtins.get_ipython
    return re.findall(r'<tr><td style="text-align:left">(.*?)</td><td>(.*?)</td>', shown[0].data)


def _jax_lbfgs():
    """The closed-form MOSM of _small_model's data with a Normal prior on
    kernel.variance, kernel.delay pegged to 0.1 · kernel.mean and
    kernel.phase fixed: its loss
    and gradient at the start, num_parameters, print_parameters' rows and
    constrained values, then LBFGS_ITERS iterations of the step that
    gpr.train(method="LBFGS") runs (optax.lbfgs() through
    _build_lbfgs_step): the losses, the trained raws and the line search's
    evaluations after each (numpy only, jax_reference.once_per_run)."""
    from mogptk_tpu.gpr import training as jtraining
    xs, ys, mean, var = _dense_data()
    _, X, Y = jgpr.merge_data(xs, ys)
    k = jgpr.MultiOutputSpectralMixtureKernel(2, output_dims=3)
    k.mean.assign(mean)
    k.variance.assign(var, prior=_JaxNormal(0.4, 0.2))
    k.delay.peg(k.mean, transform=_tenth)
    k.phase.train = False
    jm = jgpr.Exact(k, X, Y, variance=0.1)
    loss_flat, _, _ = jm.make_flat_loss_fn()
    opt = optax.lbfgs()
    step, params, _ = jtraining._build_lbfgs_step(jm, opt)
    _, fixed = jm._split_raws()
    v0, g0 = jax_reference.jit(jax.value_and_grad(loss_flat))(params, fixed)
    state = opt.init(params)
    step = jax_reference.jit(step)
    losses, raws, evals = [], [], []
    for _ in range(LBFGS_ITERS):
        params, state, v = step(params, state)
        losses.append(float(v))
        raws.append(np.asarray(params))
        evals.append(int(state[2].info.num_linesearch_steps))
    return dict(model=jax_reference.raws_and_names(jm), loss0=float(v0), grad0=np.asarray(g0),
                num_parameters=jm.num_parameters(), rows=_jax_rows(jm),
                values=[np.asarray(p()) for p in jm.parameters()],
                losses=losses, raws=raws, evals=evals, rosenbrock=_jax_rosenbrock())


ROSENBROCK_X0, ROSENBROCK_ITERS = [3.0, -3.0, 3.0, -3.0, 3.0], 40


def _rosenbrock(x):
    """The Rosenbrock function, in jnp or torch arithmetic."""
    return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2).sum()


def _jax_rosenbrock():
    """optax.lbfgs() on the 5-dimensional Rosenbrock function from
    ROSENBROCK_X0, as optax's docstring drives it: the value at the start
    of each iteration, the iterate after it and its line search's
    evaluations. Its line searches zoom by every interpolation."""
    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(_rosenbrock)

    def step(p, state):
        v, g = value_and_grad(p, state=state)
        u, state = opt.update(g, state, p, value=v, grad=g, value_fn=_rosenbrock)
        return optax.apply_updates(p, u), state, v

    p = jnp.asarray(ROSENBROCK_X0, dtype=jnp.float64)
    state = opt.init(p)
    step = jax_reference.jit(step)
    out = []
    for _ in range(ROSENBROCK_ITERS):
        p, state, v = step(p, state)
        out.append((float(v), np.asarray(p), int(state[2].info.num_linesearch_steps)))
    return out


@pytest.fixture(scope="module")
def jax_lbfgs(tmp_path_factory):
    return jax_reference.once_per_run(tmp_path_factory, "training_jax_lbfgs", _jax_lbfgs)


def test_lbfgs_with_prior_and_peg_matches_jax(jax_lbfgs):
    """gpr.train(method="LBFGS") on a closed-form MOSM with a Normal prior
    (torch.distributions) and a pegged parameter against the JAX package's
    optax.lbfgs(): the loss and gradient at the start (rtol 1e-7, atol 1e-9
    of the largest entry), num_parameters and print_parameters' rows (a
    pegged and a fixed parameter), then after each of 5 iterations the loss
    and the trained raws (rtol 1e-6, atol 1e-10 of each raw's scale) and
    the line search's
    evaluations, exactly: the model's loss() calls of the iteration, less
    the first iteration's evaluation at the start. A Wolfe branch taken
    otherwise than in the JAX run shows as a differing count in the
    message. Afterwards the pegged parameter is 0.1 · its target. Then
    gpr/lbfgs.py alone against optax.lbfgs() over 40 iterations on the
    Rosenbrock function, whose line searches zoom by cubic, quadratic and
    bisection steps (the MOSM's five take none): each iteration's value
    (rtol 1e-7), iterate (rtol 1e-6) and evaluations (exactly)."""
    import ast
    import io
    ref = jax_lbfgs
    tm = _small_model(trace_probes=None)
    k = tm.kernel
    k.variance.assign(prior=torch.distributions.Normal(torch.tensor(0.4, dtype=torch.float64),
                                                       torch.tensor(0.2, dtype=torch.float64)))
    k.delay.peg(k.mean, transform=_tenth)
    k.phase.train = False
    tgpr.load_raw_state(tm, ref["model"]["raws"], names=ref["model"]["names"])
    raws = tm.trainable_raws()
    loss = tm.loss()
    grad = torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, raws)]).numpy()
    np.testing.assert_allclose(float(loss.detach()), ref["loss0"], rtol=RTOL)
    np.testing.assert_allclose(grad, ref["grad0"], rtol=RTOL,
                               atol=1e-9 * np.abs(ref["grad0"]).max())

    assert tm.num_parameters() == ref["num_parameters"] == 6 * 3 + 1
    buf = io.StringIO()
    tm.print_parameters(file=buf)
    lines = buf.getvalue().splitlines()
    rows = [("Name", "Range")] + ref["rows"]
    w0, w1 = max(len(r[0]) for r in rows), max(len(r[1]) for r in rows)
    assert len(lines) == len(rows)
    assert dict(ref["rows"])["MultiOutputSpectralMixtureKernel.delay"] == "pegged"
    assert dict(ref["rows"])["MultiOutputSpectralMixtureKernel.phase"] == "fixed"
    for line, (name, rng), value in zip(lines[1:], ref["rows"], ref["values"]):
        head = "%-*s  %-*s  " % (w0, name, w1, rng)
        assert line.startswith(head), (line, head)
        np.testing.assert_allclose(np.array(ast.literal_eval(line[len(head):])), value,
                                   rtol=RTOL, err_msg=name)

    calls, seen = [0], []
    loss_fn = tm.loss

    def counted():
        calls[0] += 1
        return loss_fn()

    tm.loss = counted
    losses, _ = tgpr.train(tm, method="LBFGS", lr=0.5, iters=LBFGS_ITERS,
                           callback=lambda i, v: seen.append(
                               (calls[0], torch.cat([r.detach().reshape(-1) for r in raws]).numpy())))
    evals = list(np.diff([1] + [c for c, _ in seen]))
    assert evals == ref["evals"], "line-search evaluations: port %s, JAX %s" % (evals, ref["evals"])
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-6)
    for i, ((_, got), want) in enumerate(zip(seen, ref["raws"])):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10 * np.abs(want).max(),
                                   err_msg="iteration %d" % i)
    np.testing.assert_array_equal(k.delay.numpy(), 0.1 * k.mean.numpy())

    def fun(x):
        x = x.detach().requires_grad_()
        v = _rosenbrock(x)
        return v.detach(), torch.autograd.grad(v, x)[0]

    opt, x = tlbfgs.LBFGS(), torch.tensor(ROSENBROCK_X0, dtype=torch.float64)
    for i, (value, want, steps) in enumerate(ref["rosenbrock"]):
        x, got = opt.step(fun, x)
        assert opt.linesearch_steps == steps, "Rosenbrock iteration %d: %d line-search " \
            "evaluations, JAX %d" % (i, opt.linesearch_steps, steps)
        np.testing.assert_allclose(got, value, rtol=RTOL, err_msg="Rosenbrock %d" % i)
        np.testing.assert_allclose(x.numpy(), want, rtol=1e-6, atol=1e-10,
                                   err_msg="Rosenbrock %d" % i)


def test_probes():
    m1, m2 = _small_model(), _small_model()
    # drawn once per model from a seeded generator: ±1, reproducible
    assert m1.probes.shape == (120, PROBES)
    assert set(np.unique(m1.probes.numpy())) == {-1.0, 1.0}
    torch.testing.assert_close(m1.probes, m2.probes, rtol=0, atol=0)
    xs, ys, _, _ = _dense_data()
    _, X, Y = tgpr.merge_data(xs, ys)
    k = tgpr.MultiOutputSpectralMixtureKernel(2, output_dims=3)
    with pytest.raises(ValueError):
        tgpr.Exact(k, X, Y, probes=np.ones((120, 4)), trace_probes=5)
    with pytest.raises(ValueError):
        tgpr.Exact(k, X, Y, probes=np.ones((119, 4)))
    assert tgpr.Exact(k, X, Y, probes=np.ones((120, 4))).trace_probes == 4


def test_device_defaults_to_the_card():
    """Without a device the port asks for CUDA; where there is none it
    raises instead of carrying on on the CPU. The dtype's auto rule is
    float32, as in the JAX package without x64."""
    cfg = tgpr.config
    saved = (cfg.device, cfg._dtype)
    try:
        cfg.device, cfg._dtype = tgpr.Config().device, None
        assert cfg.device == "cuda" and cfg.dtype == torch.float32
        if torch.cuda.is_available():
            pytest.skip("this machine has CUDA")
        xs, ys, _, _ = _dense_data()
        with pytest.raises(RuntimeError):
            tgpr.merge_data(xs, ys)
        _, X, Y = tgpr.merge_data(xs, ys, device="cpu")
        k = tgpr.MultiOutputSpectralMixtureKernel(2, output_dims=3)
        with pytest.raises(RuntimeError):
            tgpr.Exact(k, X, Y, variance=0.1, trace_probes=PROBES)
        model = tgpr.Exact(k, X, Y, variance=0.1, trace_probes=PROBES, device="cpu")
        assert model.X.device.type == "cpu" and model.X.dtype == torch.float32
    finally:
        cfg.device, cfg._dtype = saved


def test_blocked_cholesky_returns_every_panel_inverse():
    """One inverse per block column, the last included (the solve needs all
    of them); None when n had to be padded."""
    rng = np.random.RandomState(3)
    A = rng.randn(192, 192) / 14
    K = torch.as_tensor(A @ A.T + 2 * np.eye(192))
    L, invs = tbc.blocked_cholesky(K.clone(), block_size=64, return_panel_invs=True)
    assert invs.shape == (3, 64, 64)
    for i in range(3):
        blk = L[i * 64:(i + 1) * 64, i * 64:(i + 1) * 64]
        torch.testing.assert_close(invs[i] @ blk, torch.eye(64, dtype=torch.float64),
                                   rtol=0, atol=1e-12)
    _, invs = tbc.blocked_cholesky(K[:160, :160].clone(), block_size=64, return_panel_invs=True)
    assert invs is None
