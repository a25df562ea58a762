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


def test_unported_configurations_raise():
    """What is not ported raises NotImplementedError naming its ROADMAP
    item: LBFGS. (The closed-form gradient, unsorted channels and the sparse
    selectors, which raised here before, now train: test_torch_closed_form.py,
    test_torch_sparse.py; so do a mean function and the SM-model
    initialization: test_torch_singleoutput.py; and the sparse and
    variational models with a non-Gaussian likelihood:
    test_torch_likelihood.py.)"""
    with pytest.raises(NotImplementedError, match="LBFGS.*queue 1, item 8"):
        tgpr.train(_small_model(), method="LBFGS", iters=1)


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
