"""The exact-GP prediction slice of mogptk_tpu_torch against mogptk_tpu.

Both packages build the same model from the same numpy data (bench.py's
generator, cut to 4 channels x 48 points) in float64 on the CPU; the JAX
model's raw parameters are carried across with load_raw_state. Tolerance
rtol 1e-7: XLA-CPU's exp is only ~1e-8 accurate even in float64.
"""
import numpy as np
import pytest
import torch

import mogptk_tpu.gpr as jgpr
import mogptk_tpu_torch.gpr as tgpr
from mogptk_tpu_torch.ops import blocked_cholesky, mosm_gram

RTOL = 1e-7
CHANNELS, N_PER, Q = 4, 48, 2


def _data():
    rng = np.random.RandomState(0)
    xs, ys = [], []
    for j in range(CHANNELS):
        x = np.sort(rng.uniform(0.0, 100.0, N_PER)).reshape(-1, 1)
        y = (np.sin(0.5 * x[:, 0] + j) + 0.4 * np.cos(2.1 * x[:, 0])
             + 0.1 * rng.randn(N_PER)).reshape(-1, 1)
        xs.append(x)
        ys.append(y)
    return xs, ys


def _queries():
    rng = np.random.RandomState(2)
    # like request (a): every channel, spanning [0, 110] (part extrapolates)
    xa = np.concatenate([np.stack([np.full(8, c), np.sort(rng.uniform(0, 110, 8))], 1)
                         for c in range(CHANNELS)])
    # like request (c): one channel only
    xc = np.stack([np.full(16, 2.0), np.sort(rng.uniform(0, 110, 16))], 1)
    return [xa, xc]


def _models():
    xs, ys = _data()
    rng = np.random.RandomState(1)
    mean = 0.05 + 0.3 * rng.rand(CHANNELS, Q, 1)
    variance = 0.2 + 0.3 * rng.rand(CHANNELS, Q, 1)

    _, X, Y = jgpr.merge_data(xs, ys)
    jk = jgpr.MultiOutputSpectralMixtureKernel(Q, output_dims=CHANNELS)
    jk.mean.assign(mean)
    jk.variance.assign(variance)
    jm = jgpr.Exact(jk, X, Y, variance=0.1)

    _, Xt, Yt = tgpr.merge_data(xs, ys)
    tk = tgpr.MultiOutputSpectralMixtureKernel(Q, output_dims=CHANNELS)
    tm = tgpr.Exact(tk, Xt, Yt, variance=0.1)
    tgpr.load_raw_state(tm, [np.asarray(r) for r in jm.raw_state()],
                        names=[p.name for p in jm.parameters()])
    return jm, tm


@pytest.fixture(scope="module", autouse=True)
def cpu_device():
    """The port runs on the card unless asked: these tests ask for the CPU,
    on one thread (the suite runs files in parallel processes)."""
    saved = tgpr.config.device, torch.get_num_threads()
    tgpr.config.device = "cpu"
    torch.set_num_threads(1)
    yield
    tgpr.config.device = saved[0]
    torch.set_num_threads(saved[1])


@pytest.fixture(scope="module")
def jax_results():
    """The JAX model's answers, computed once for every case below."""
    jm, _ = _models()
    out = []
    for Xq in _queries():
        mu, var = jm.predict_f(Xq)
        bands = jm.predict_y(Xq, sigma=2)
        out.append((np.asarray(mu), np.asarray(var), [np.asarray(b) for b in bands]))
    # loss() is the jitted −LML − log prior, and there are no priors; the
    # eager log_marginal_likelihood() costs seconds of op-by-op dispatch
    return out, -jm.loss()


@pytest.fixture
def port_config():
    cfg = tgpr.config
    saved = (cfg.dtype, cfg.blocked_cholesky, cfg.blocked_cholesky_block)
    tgpr.use_double_precision()
    yield cfg
    cfg.dtype, cfg.blocked_cholesky, cfg.blocked_cholesky_block = saved


def _launches():
    return (mosm_gram.mosm_gram.launches, blocked_cholesky.s_panel.launches,
            blocked_cholesky.col_write.launches)


@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked64"])
def test_predict_and_lml_match_jax(port_config, jax_results, blocked):
    if blocked:
        # N = 192 factors in three 64-wide block columns through the kernels'
        # plain twins (CPU tensors)
        tgpr.use_blocked_cholesky(True, block_size=64)
    _, tm = _models()
    assert tm._channel_counts == (N_PER,) * CHANNELS
    answers, lml = jax_results
    before = _launches()
    for Xq, (jmu, jvar, jbands) in zip(_queries(), answers):
        tmu, tvar = tm.predict_f(Xq)
        np.testing.assert_allclose(tmu.numpy(), jmu, rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(tvar.numpy(), jvar, rtol=RTOL, atol=1e-12)
        tbands = tm.predict_y(Xq, sigma=2)
        assert len(tbands) == 3
        for a, b in zip(tbands, jbands):
            np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(float(tm.log_marginal_likelihood()), lml, rtol=RTOL)
    # CPU tensors never launch a kernel
    assert _launches() == before


def test_parameters_carry_across(port_config):
    jm, tm = _models()
    assert tgpr.parameter_names(tm) == [p.name for p in jm.parameters()]
    for a, b in zip(tgpr.raw_state_numpy(tm), jm.raw_state()):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the same bijector on the same raw values: identical constrained values
    for (_, p), jp in zip(tm.gp_parameters(), jm.parameters()):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp.constrained), rtol=1e-14)
    raws = [np.asarray(r) for r in jm.raw_state()]
    with pytest.raises(ValueError):
        tgpr.load_raw_state(tm, raws[:-1])
    with pytest.raises(ValueError):
        tgpr.load_raw_state(tm, raws[:1] + [raws[1][..., 0]] + raws[2:])
    with pytest.raises(ValueError):
        tgpr.load_raw_state(tm, raws, names=["x"] * len(raws))


def test_kernel_call_checks_channel_ids(port_config):
    _, tm = _models()
    X = tm.X[:10]
    np.testing.assert_array_equal(tm.kernel(X).detach().numpy(), tm.kernel.K(X).detach().numpy())
    bad = X.clone()
    bad[0, 0] = CHANNELS          # out of range
    with pytest.raises(ValueError):
        tm.kernel(bad)
    bad[0, 0] = 0.5               # not an integer
    with pytest.raises(ValueError):
        tm.kernel(X, bad)


@pytest.mark.parametrize("x", [-300.0, -5.0, 0.0, 5.0, 199.0, 201.0, 400.0])
def test_softplus_matches_jax_across_threshold(x):
    """beta·x > 20 (x > 200) is the identity branch in both packages."""
    for lower, beta in [(1e-8, 0.1), (2.0, -0.1)]:
        j = jgpr.Softplus(lower=lower, beta=beta).forward(np.float64(x))
        t = tgpr.Softplus(lower=lower, beta=beta).forward(torch.tensor(x, dtype=torch.float64))
        np.testing.assert_allclose(float(t), float(j), rtol=1e-13)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError):
        tgpr.resolve_device("cuda")
