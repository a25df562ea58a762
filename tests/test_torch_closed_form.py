"""The exact-GP training path without the fused probe-trace LML, in
mogptk_tpu_torch against mogptk_tpu: the closed-form gradient
(Exact(trace_probes=None)) on channel-sorted and shuffled channels, on the
unblocked route and on the blocked route (the inverse from the factor), the
probe-trace gradient on shuffled channels (the dense dK through the Gram's
backward), and three Adam steps.

Both packages build the model on the same numpy data in float64 on the CPU;
the JAX model's raws are carried across with load_raw_state. The JAX side
runs its Gram through the plain jnp reference (Pallas is off on the CPU; its
B2 and C1b kernels are held against the port in interpret mode in
tests/test_torch_gram_bwd.py); the port runs its kernels' plain twins on CPU
tensors. rtol 1e-7 (XLA-CPU's exp is only ~1e-8
accurate even in float64); each atol is stated relative to the output's
scale. The JAX answers are computed once per module.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

import mogptk_tpu.gpr as jgpr
import mogptk_tpu_torch.gpr as tgpr
from mogptk_tpu_torch.ops import mosm_gram as tmg

RTOL = 1e-7
PROBES, SEED, LR, STEPS = 8, 3, 0.01, 3


@pytest.fixture(scope="module", autouse=True)
def cpu_float64():
    """The port runs on the card unless asked: these tests ask for the CPU,
    on one thread."""
    cfg = tgpr.config
    saved = (cfg.device, cfg._dtype, cfg.blocked_cholesky, cfg.blocked_cholesky_block,
             torch.get_num_threads())
    cfg.device = "cpu"
    tgpr.use_double_precision()
    torch.set_num_threads(1)
    yield
    (cfg.device, cfg._dtype, cfg.blocked_cholesky, cfg.blocked_cholesky_block, threads) = saved
    torch.set_num_threads(threads)


def _data(shuffle):
    """3 channels x 40 points (tests/test_linalg.py TestLmlCholFused's data),
    shuffled by a fixed permutation when asked."""
    rng = np.random.RandomState(0)
    xs = [np.sort(rng.rand(40, 1) * 10, axis=0) for _ in range(3)]
    ys = [np.sin(1.3 * x + i) + 0.05 * rng.randn(40, 1) for i, x in enumerate(xs)]
    X = np.concatenate([np.concatenate([np.full((40, 1), float(i)), x], axis=1)
                        for i, x in enumerate(xs)])
    Y = np.concatenate(ys)
    if shuffle:
        perm = np.random.RandomState(1).permutation(X.shape[0])
        X, Y = X[perm], Y[perm]
    rk = np.random.RandomState(1)
    return X, Y, 0.05 + 0.3 * rk.rand(3, 2, 1), 0.2 + 0.3 * rk.rand(3, 2, 1)


def _jax_model(shuffle, trace_probes=None):
    X, Y, mean, var = _data(shuffle)
    k = jgpr.MultiOutputSpectralMixtureKernel(2, output_dims=3)
    k.mean.assign(mean)
    k.variance.assign(var)
    return jgpr.Exact(k, X, Y, variance=0.1, trace_probes=trace_probes, seed=SEED)


def _port_model(shuffle, jm, **kw):
    X, Y, _, _ = _data(shuffle)
    tm = tgpr.Exact(tgpr.MultiOutputSpectralMixtureKernel(2, output_dims=3), X, Y,
                    variance=0.1, **kw)
    tgpr.load_raw_state(tm, [np.asarray(r) for r in jm.raw_state()],
                        names=[p.name for p in jm.parameters()])
    return tm


def _jax_run(jm, steps):
    """Loss and gradient at the start, then the raws after each of `steps`
    optax Adam steps (one jitted value-and-grad, the update of
    gpr/training.py)."""
    train, fixed = jm._split_raws()
    vg = jax.jit(jax.value_and_grad(jm.make_loss_fn()))
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
    return losses, grads, raws


@pytest.fixture(scope="module")
def jax_sorted():
    jm = _jax_model(False)
    return (jm,) + _jax_run(jm, STEPS)


@pytest.fixture(scope="module")
def jax_shuffled():
    jm = _jax_model(True)
    return (jm,) + _jax_run(jm, 0)


@pytest.fixture(scope="module")
def jax_shuffled_probes():
    jm = _jax_model(True, trace_probes=PROBES)
    assert jm._fused_static() is None        # unsorted: the dense stochastic LML
    Z = np.asarray(jax.random.rademacher(jax.random.PRNGKey(SEED), (120, PROBES),
                                         dtype=jnp.float64))
    return (jm, Z) + _jax_run(jm, 0)


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


@pytest.mark.parametrize("route", ["unblocked", "blocked"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["sorted", "shuffled"])
def test_closed_form_loss_and_gradients_match_jax(shuffle, route, jax_sorted, jax_shuffled,
                                                  monkeypatch):
    """The closed-form LML and every raw's gradient. Unblocked: the full
    Gram, torch.linalg.cholesky_ex and torch.cholesky_inverse. Blocked
    (forced at block 40, which divides n = 120): the blocked factor with every
    panel inverse, the K-solve twin and K⁻¹ from the factor
    (spd_inverse_from_factor). Either way the dense dK goes through
    MosmGram's backward, the K-gram-bwd twin."""
    jm, losses, grads, _ = jax_shuffled if shuffle else jax_sorted
    calls = []
    twin = tmg.mosm_gram_bwd_plain
    monkeypatch.setattr(tmg, "mosm_gram_bwd_plain", lambda *a: calls.append(1) or twin(*a))
    if route == "blocked":
        tgpr.use_blocked_cholesky(True, block_size=40)
    try:
        tm = _port_model(shuffle, jm)
        assert tm._fused_static() is None and tm.trace_probes is None
        assert (tm._channel_counts is None) == shuffle
        _check_loss_and_grads(tm, losses[0], grads[0])
    finally:
        tgpr.use_blocked_cholesky(None)
    assert calls == [1]


def test_probe_trace_gradient_on_shuffled_channels_matches_jax(jax_shuffled_probes):
    """Exact(trace_probes=8) on shuffled channels against the JAX package's
    lml_quadform_logdet_stochastic_shifted with the same probes Z =
    rademacher(PRNGKey(3), (120, 8)) (ops/linalg.py:383)."""
    jm, Z, losses, grads, _ = jax_shuffled_probes
    tm = _port_model(True, jm, probes=Z)
    assert tm._fused_static() is None and tm.trace_probes == PROBES
    _check_loss_and_grads(tm, losses[0], grads[0])


def test_three_closed_form_adam_steps_match_jax(jax_sorted):
    """gpr.train(method="Adam", lr=0.01) with the closed-form gradient:
    torch.optim.Adam per raw against optax.adam on the same raws; the raws
    after each step and the losses. rtol 1e-7, atol 1e-10 of each raw's
    scale."""
    jm, losses, _, raws = jax_sorted
    tm = _port_model(False, jm)
    seen = []
    got_losses, _ = tgpr.train(tm, method="Adam", lr=LR, iters=STEPS,
                               callback=lambda i, v: seen.append(tgpr.raw_state_numpy(tm)))
    np.testing.assert_allclose(got_losses, losses[:STEPS], rtol=RTOL)
    for step, (got, ref) in enumerate(zip(seen, raws)):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-10 * max(np.abs(b).max(), 1.0),
                                       err_msg="step %d" % step)


def test_dense_cotangents_column_route_matches_inverse():
    """_dense_lml_cotangents on the blocked route at n = 1,100: without panel
    inverses the panel width (1,024) does not divide n (the column-blocked
    double solve); with the factorization's inverses at block 100 it does (the
    inverse from the factor). Both against ½g(ααᵀ − K⁻¹) from numpy's
    inverse. L's strict upper holds NaN: no route may read it. rtol 1e-9."""
    from mogptk_tpu_torch.ops import linalg as tla
    rng = np.random.RandomState(4)
    n = 1100
    A = rng.randn(n, n) / np.sqrt(n)
    K = A @ A.T + 2.0 * np.eye(n)
    L = np.linalg.cholesky(K) + np.triu(np.full((n, n), np.nan), 1)
    alpha = rng.randn(n, 1)
    ref = 0.35 * (alpha @ alpha.T - np.linalg.inv(K))
    tgpr.use_blocked_cholesky(True)
    try:
        for invs in (None, torch.stack([torch.linalg.inv(torch.as_tensor(
                np.tril(L)[i:i + 100, i:i + 100])) for i in range(0, n, 100)])):
            dK, dy = tla._dense_lml_cotangents(torch.as_tensor(L), torch.as_tensor(alpha), 0.7,
                                               invs)
            np.testing.assert_allclose(dK.numpy(), ref, rtol=1e-9, atol=1e-12 * np.abs(ref).max())
            np.testing.assert_allclose(dy.numpy(), -0.7 * alpha, rtol=0)
    finally:
        tgpr.use_blocked_cholesky(None)


@pytest.mark.parametrize("width", [17, 70])
def test_cholesky_solve_routes_wide_right_hand_sides_to_the_gemm_sweeps(width, monkeypatch):
    """With panel inverses, up to 64 right-hand sides go through
    fused_cho_solve (K-solve on the card) and wider ones through the blocked
    GEMM sweeps, as the JAX package routes them (ops/linalg.py
    cholesky_solve): on the card K-solve takes at most 64 and would raise,
    e.g. for Exact(trace_probes=64). Both against torch.cholesky_solve,
    rtol 1e-10."""
    from mogptk_tpu_torch.ops import linalg as tla
    from mogptk_tpu_torch.ops import blocked_trisolve as tbt
    rng = np.random.RandomState(6)
    n = 256
    A = rng.randn(n, n) / np.sqrt(n)
    L = torch.linalg.cholesky(torch.as_tensor(A @ A.T + 2.0 * np.eye(n)))
    B = torch.as_tensor(rng.randn(n, width))
    calls = []
    fused = tla.fused_cho_solve
    monkeypatch.setattr(tla, "fused_cho_solve", lambda *a: calls.append(1) or fused(*a))
    X = tla.cholesky_solve(L, B, invs=tbt.panel_inverses(L, block_size=64))
    assert calls == ([1] if width <= 64 else [])
    torch.testing.assert_close(X, torch.cholesky_solve(B, L), rtol=1e-10, atol=1e-12)
