"""The user API of mogptk_tpu_torch (DataSet → MOSM → init_parameters →
train → predict → error, save/LoadModel) against mogptk_tpu's, on the CPU
in float64.

Both packages get the same numpy data and the same set_seed, so the MOSM
constructor's random initial parameters and the random test split come
from the same numpy Generator draws. The JAX flows run once per module, the
port's too; each test compares one stage. rtol 1e-7 (XLA-CPU's exp is only
~1e-8 accurate even in float64) unless stated.
"""
import os
import warnings

import numpy as np
import pytest
import jax
import torch

import mogptk_tpu as J
import mogptk_tpu_torch as T

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
    params = lambda m: [np.asarray(p()) if pkg is J else p.numpy() for p in
                        (m.gpr.parameters() if pkg is J else m.parameters())]
    out["init"] = params(model)
    model.init_parameters("LS")
    out["ls"] = params(model)
    out["losses"], _ = model.train(method="Adam", lr=0.01, iters=3)
    out["trained"] = params(model)
    out["predict"] = model.predict()
    out["mae"] = model.error("MAE")
    out["model"] = model
    bnse = pkg.MOSM(_dataset(pkg, 1, 50), Q=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bnse.init_parameters("BNSE", iters=5)
    out["bnse"] = params(bnse)
    return out


@pytest.fixture(scope="module")
def flows():
    return _flow(J), _flow(T)


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


def test_bnse_initialization_matches_jax(flows):
    """BNSE on a 50-point signal: the inner spectral-kernel GP trains 5
    closed-form Adam steps (lr 2.0), then the frequency-domain posterior."""
    j, t = flows
    _close(j["bnse"], t["bnse"], "parameter")
    assert np.all(t["bnse"][0] > 1e-6)          # the peaks were found


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


def test_save_and_load_round_trip(flows, tmp_path):
    """save() then LoadModel(): the loaded model predicts what the saved one
    did, with its tensors on the asked device."""
    model = flows[1]["model"]
    path = os.path.join(str(tmp_path), "mosm")
    model.save(path)
    loaded = T.LoadModel(path, device="cpu")
    assert loaded.gpr.X.device.type == "cpu"
    for a, b in zip(model.predict(), loaded.predict()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_load_raw_state_from_a_jax_mosm(flows):
    """gpr.load_raw_state takes a top-level model: a trained JAX MOSM's raws
    go into a fresh port MOSM, which then predicts as the JAX one."""
    jm = flows[0]["model"]
    tm = T.MOSM(_dataset(T, 3, 40), Q=2)
    T.gpr.load_raw_state(tm, [np.asarray(r) for r in jm.gpr.raw_state()],
                         names=[p.name for p in jm.gpr.parameters()])
    for a, b in zip(jm.predict(), tm.predict()):
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
