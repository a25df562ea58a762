"""The user API of mogptk_tpu_torch (DataSet → MOSM → init_parameters →
train → predict → error, save/LoadModel) against mogptk_tpu's, on the CPU
in float64.

Both packages get the same numpy data and the same set_seed, so the MOSM
constructor's random initial parameters and the random test split come
from the same numpy Generator draws. The JAX flow runs once per test run
(tests/jax_reference.py), the port's once per module; each test compares
one stage. rtol 1e-7 (XLA-CPU's exp is only
~1e-8 accurate even in float64) unless stated.
"""
import copy
import io
import os
import warnings

import numpy as np
import pytest
import jax
import torch

import mogptk_tpu as J
import mogptk_tpu_torch as T

import jax_reference

RTOL = 1e-7


@pytest.fixture(scope="module", autouse=True)
def cpu_float64():
    cfg = T.gpr.config
    saved = (cfg.device, cfg._dtype, torch.get_num_threads())
    cfg.device = "cpu"
    T.use_double_precision()
    torch.set_num_threads(1)
    yield
    cfg.device, cfg._dtype, threads = saved
    torch.set_num_threads(threads)


def _dataset(pkg, channels, n):
    """`channels` noisy sinusoids of n points on [0, 10]; 20% of each
    channel removed at random (the package's seeded Generator)."""
    pkg.set_seed(5)
    rng = np.random.RandomState(0)
    t = np.linspace(0.0, 10.0, n)
    ys = [np.sin(1.3 * t + i) + 0.1 * rng.randn(n) for i in range(channels)]
    ds = pkg.DataSet([t] * channels, ys, names=["ch%d" % i for i in range(channels)])
    for ch in ds:
        ch.remove_randomly(pct=0.2)
    return ds


def _flow(pkg):
    """The quick start, with what each stage leaves behind."""
    out = {}
    model = pkg.MOSM(_dataset(pkg, 3, 40), Q=2)
    params = lambda m: _params(pkg, m)
    out["init"] = params(model)
    model.init_parameters("LS")
    out["ls"] = params(model)
    out["losses"], _ = model.train(method="Adam", lr=0.01, iters=3)
    out["trained"] = params(model)
    out["predict"] = model.predict()
    out["mae"] = model.error("MAE")
    if pkg is J:
        # numpy only, so one worker's answers serve every worker
        out["raws"] = [np.asarray(r) for r in model.gpr.raw_state()]
        out["names"] = [p.name for p in model.gpr.parameters()]
        # save_parameters' file, as bytes, and the loss it gives
        buf = io.BytesIO()
        model.save_parameters(buf)
        out["npz"] = buf.getvalue()
        out["loss"] = model.loss()
    else:
        out["model"] = model
    return out


def _bnse(pkg):
    """The parameters a one-channel MOSM gets from init_parameters('BNSE');
    _dataset reseeds, so this is independent of _flow."""
    model = pkg.MOSM(_dataset(pkg, 1, 50), Q=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model.init_parameters("BNSE", iters=5)
    return _params(pkg, model)


def _params(pkg, model):
    """A model's parameter values, numpy."""
    if pkg is J:
        return [np.asarray(p()) for p in model.gpr.parameters()]
    return [p.numpy() for p in model.parameters()]


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    """The JAX flow once per test run (jax_reference.once_per_run), the
    port's in this process."""
    return jax_reference.once_per_run(tmp_path_factory, "user_api_jax_flow",
                                      lambda: _flow(J)), _flow(T)


@pytest.fixture(scope="module")
def bnse_params(tmp_path_factory):
    """BNSE apart from the flow, so that parallel workers compute the two
    JAX references side by side."""
    return jax_reference.once_per_run(tmp_path_factory, "user_api_jax_bnse",
                                      lambda: _bnse(J)), _bnse(T)


def _close(a, b, what, atol=1e-12):
    """Each array of b against a: rtol 1e-7, atol `atol` of the array's
    scale."""
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_allclose(y, x, rtol=RTOL, atol=atol * max(np.abs(x).max(), 1.0),
                                   err_msg="%s %d" % (what, i))


def test_mosm_initial_parameters_match_jax(flows):
    """MOSM(DataSet, Q=2) draws weight, mean and variance from
    gpr.config.numpy_rng() and bounds the mean by the Nyquist estimate."""
    j, t = flows
    assert len(j["init"]) == len(t["init"]) == 6
    _close(j["init"], t["init"], "parameter")


def test_ls_initialization_matches_jax(flows):
    j, t = flows
    _close(j["ls"], t["ls"], "parameter")


def test_bnse_initialization_matches_jax(bnse_params):
    """BNSE on a 50-point signal: the inner spectral-kernel GP trains 5
    closed-form Adam steps (lr 2.0), then the frequency-domain posterior."""
    j, t = bnse_params
    _close(j, t, "parameter")
    assert np.all(t[0] > 1e-6)          # the peaks were found


def test_train_losses_and_parameters_match_jax(flows):
    """train(Adam, lr=0.01, iters=3): the loss history and the parameters
    after it. atol 5e-8 of each parameter's scale: the second component's
    delay and phase gradients cancel to 0 here and to summation noise
    (~4e-15) in the JAX package, and Adam moves a raw by lr·g/(|g| + ε) with
    ε = 1e-8, up to 4e-9 a step for that noise."""
    j, t = flows
    assert t["losses"].shape == (4,)
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=RTOL)
    _close(j["trained"], t["trained"], "parameter", atol=5e-8)


def test_predict_and_error_match_jax(flows):
    """predict(): per channel X, mean and the two-sigma bands; error('MAE')
    on the removed points."""
    j, t = flows
    for a, b in zip(j["predict"], t["predict"]):
        _close(a, b, "channel")
    np.testing.assert_allclose(t["mae"], j["mae"], rtol=RTOL)


def _tenth(m):
    """The peg's transform: a module-level function, so a model pegged
    through it pickles."""
    return 0.1 * m


def test_save_and_load_round_trip(flows, tmp_path):
    """save() then LoadModel(): the loaded model predicts what the saved one
    did, with its tensors on the asked device. Then a copy of it with a
    Normal prior on kernel.variance and kernel.delay pegged to
    0.1 · kernel.mean: copy.deepcopy pegs the copy to its own target;
    save()/LoadModel() keep the peg inside the loaded model, with the same
    loss; save_parameters()/load_parameters() round-trip every raw
    bitwise; and the .npz that the JAX model's save_parameters() wrote
    loads into the port's MOSM and gives the JAX loss (rtol 1e-7). On the
    way: a peg leaves the parameters' order as it was, assign(name=) keeps
    the owner's prefix, and a prior on another device raises."""
    j, t = flows
    model = t["model"]
    path = os.path.join(str(tmp_path), "mosm")
    model.save(path)
    loaded = T.LoadModel(path, device="cpu")
    assert loaded.gpr.X.device.type == "cpu"
    for a, b in zip(model.predict(), loaded.predict()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    m = copy.deepcopy(model)
    k = m.gpr.kernel
    k.variance.assign(prior=torch.distributions.Normal(torch.tensor(0.4, dtype=torch.float64),
                                                       torch.tensor(0.2, dtype=torch.float64)))
    k.delay.peg(k.mean, transform=_tenth)
    assert float(k.variance.log_prior().detach()) != 0.0 and m.num_parameters() == model.num_parameters() - 6
    kk = T.gpr.MultiOutputSpectralMixtureKernel(2, output_dims=3)
    order = [n for n, _ in kk.gp_parameters()]
    kk.weight.peg(kk.phase)       # a target registered after the pegged parameter
    assert [n for n, _ in kk.gp_parameters()] == order
    k.weight.assign(name="amplitude")     # the owner's prefix stays, as in the JAX package
    assert "MultiOutputSpectralMixtureKernel.amplitude" in T.gpr.parameter_names(m.gpr)
    with pytest.raises(ValueError, match="meta.*cpu"):
        T.gpr.Parameter(1.0, prior=torch.distributions.Normal(
            torch.zeros((), device="meta"), torch.ones((), device="meta"),
            validate_args=False)).log_prior()
    clone = copy.deepcopy(m)
    ck = clone.gpr.kernel
    assert ck.delay.pegged_parameter is ck.mean and ck.delay.pegged_parameter is not k.mean
    k.mean.assign(0.7 * np.ones(k.mean.shape))
    assert not np.allclose(ck.delay.numpy(), k.delay.numpy())
    np.testing.assert_array_equal(ck.delay.numpy(), 0.1 * ck.mean.numpy())

    m.save(path)
    loaded = T.LoadModel(path, device="cpu")
    lk = loaded.gpr.kernel
    assert lk.delay.pegged_parameter is lk.mean and lk.variance.prior is not None
    assert [n for n, _ in loaded.gpr.gp_parameters()] == [n for n, _ in model.gpr.gp_parameters()]
    assert loaded.loss() == m.loss()

    m.save_parameters(path)
    clone.load_parameters(path)
    for a, b in zip(clone.gpr.raw_state(), m.gpr.raw_state()):
        assert torch.equal(a, b)
    assert clone.loss() == m.loss()

    with open(os.path.join(str(tmp_path), "jax.npz"), "wb") as f:
        f.write(j["npz"])
    fresh = T.MOSM(_dataset(T, 3, 40), Q=2)
    fresh.load_parameters(os.path.join(str(tmp_path), "jax"))
    np.testing.assert_allclose(fresh.loss(), j["loss"], rtol=RTOL)
    with pytest.raises(ValueError, match="shape mismatch"):
        T.MOSM(_dataset(T, 3, 40), Q=3).load_parameters(os.path.join(str(tmp_path), "jax"))


def test_load_raw_state_from_a_jax_mosm(flows):
    """gpr.load_raw_state takes a top-level model: a trained JAX MOSM's raws
    go into a fresh port MOSM, which then predicts as the JAX one did."""
    j = flows[0]
    tm = T.MOSM(_dataset(T, 3, 40), Q=2)
    T.gpr.load_raw_state(tm, j["raws"], names=j["names"])
    for a, b in zip(j["predict"], tm.predict()):
        _close(a, b, "channel")


def test_a_model_built_without_a_device_asks_for_the_card():
    """The device default is the card: without CUDA, a top-level model built
    without a device raises instead of running on the CPU."""
    cfg = T.gpr.config
    saved = cfg.device
    try:
        cfg.device = T.gpr.Config().device
        assert cfg.device == "cuda"
        if torch.cuda.is_available():
            pytest.skip("this machine has CUDA")
        ds = _dataset(T, 2, 20)
        with pytest.raises(RuntimeError, match="cuda"):
            T.MOSM(ds, Q=1)
        assert T.MOSM(ds, Q=1, device="cpu").gpr.X.device.type == "cpu"
    finally:
        cfg.device = saved
