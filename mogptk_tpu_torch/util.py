"""Error metrics, cross-model comparison, and mixture-PSD plotting.

Capability parity with mogptk/util.py:6-234. Pure NumPy/matplotlib — host
side, outside the device compute path. A copy of mogptk_tpu/util.py, kept in
this package so that it imports nothing of the JAX package.
"""
import numpy as np


def mean_absolute_error(y_true, y_pred):
    """MAE (reference: mogptk/util.py:6-11)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return np.mean(np.abs(y_true - y_pred))


def mean_absolute_percentage_error(y_true, y_pred):
    """MAPE in percent; values with y ≤ 1e-6 are excluded
    (reference: mogptk/util.py:13-20)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    idx = 1e-6 < y_true
    y_true, y_pred = y_true[idx], y_pred[idx]
    return np.mean(np.abs((y_true - y_pred) / y_true)) * 100.0


def symmetric_mean_absolute_percentage_error(y_true, y_pred):
    """sMAPE in percent (reference: mogptk/util.py:22-29).

    Known reference defect, intentionally fixed: the reference filters on
    ``1e-6 < y_true`` only and divides by the signed sum, which makes the
    "symmetric" metric asymmetric in its arguments and NaN for all-zero
    inputs. Here we use the textbook form: pairs are kept when
    ``|y_true| + |y_pred| > 1e-6`` and the denominator is that absolute sum,
    so sMAPE(a, b) == sMAPE(b, a) and the all-equal case returns 0.
    """
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    denom = np.abs(y_true) + np.abs(y_pred)
    idx = 1e-6 < denom
    if not idx.any():
        return 0.0
    return np.mean(np.abs(y_true[idx] - y_pred[idx]) / denom[idx]) * 200.0


def mean_squared_error(y_true, y_pred):
    """MSE (reference: mogptk/util.py:31-36)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return np.mean((y_true - y_pred) ** 2)


def root_mean_squared_error(y_true, y_pred):
    """RMSE (reference: mogptk/util.py:38-43)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return np.sqrt(np.mean((y_true - y_pred) ** 2))


def error(*models, X=None, Y=None, per_channel=False, transformed=False, disp=False):
    """Cross-model test-error comparison table (reference: mogptk/util.py:46-128).

    Returns a list (per model) of dicts with Name/MAE/MAPE/RMSE, or nested
    per-channel lists when per_channel=True.
    """
    if len(models) == 0:
        raise ValueError("must pass models")
    elif X is None and Y is None:
        X, Y = models[0].dataset.get_test_data(transformed=transformed)
        for model in models[1:]:
            X2, Y2 = model.dataset.get_test_data(transformed=transformed)
            if (len(X) != len(X2)
                    or not all(np.array_equal(X[j], X2[j]) for j in range(len(X)))
                    or not all(np.array_equal(Y[j], Y2[j]) for j in range(len(X)))):
                raise ValueError("models use different data sets; pass X and Y explicitly to compare them")
        if sum(x.size for x in X) == 0:
            raise ValueError("models have no test data")
    elif (X is None) != (Y is None):
        raise ValueError("X and Y must both be set or omitted")

    output_dims = models[0].dataset.get_output_dims()
    for model in models[1:]:
        if model.dataset.get_output_dims() != output_dims:
            raise ValueError("all models must have the same number of channels")
    if not isinstance(X, list):
        X = [X] * output_dims
    if not isinstance(Y, list):
        Y = [Y] * output_dims
    if len(X) != output_dims or len(X) != len(Y):
        raise ValueError("X and Y must be lists with as many entries as channels")

    Y_true = Y
    errors = []
    for k, model in enumerate(models):
        name = model.name
        if name is None:
            name = "Model %d" % (k + 1,)

        _, Y_pred, _, _ = model.predict(X, transformed=transformed)
        if len(model.dataset) == 1 and not isinstance(Y_pred, list):
            Y_pred = [Y_pred]

        if per_channel:
            model_errors = []
            for j in range(model.dataset.get_output_dims()):
                model_errors.append({
                    "Name": name + " channel " + str(j + 1),
                    "MAE": mean_absolute_error(Y_true[j], Y_pred[j]),
                    "MAPE": mean_absolute_percentage_error(Y_true[j], Y_pred[j]),
                    "RMSE": root_mean_squared_error(Y_true[j], Y_pred[j]),
                })
            errors.append(model_errors)
        else:
            Ys_true = np.concatenate(Y_true, axis=0)
            Ys_pred = np.concatenate(Y_pred, axis=0)
            errors.append({
                "Name": name,
                "MAE": mean_absolute_error(Ys_true, Ys_pred),
                "MAPE": mean_absolute_percentage_error(Ys_true, Ys_pred),
                "RMSE": root_mean_squared_error(Ys_true, Ys_pred),
            })

    if disp:
        import pandas as pd
        if per_channel:
            df = pd.DataFrame([item for sublist in errors for item in sublist])
        else:
            df = pd.DataFrame(errors)
        df.set_index("Name", inplace=True)
        try:
            from IPython.display import display
            display(df)
        except ImportError:
            print(df)
    else:
        return errors


def _mixture_arg(a, name, shape, expand_axis):
    """Validate/normalize a mixture-spectrum argument to ``shape`` by
    expanding a missing trailing axis."""
    a = np.array(a)
    if a.ndim == len(shape) - 1:
        a = np.expand_dims(a, axis=expand_axis)
    if a.ndim != len(shape) or any(
            s is not None and a.shape[k] != s for k, s in enumerate(shape)):
        dims = ("mixtures", "output_dims", "input_dims")
        want = tuple(dims[k] if s is None else s for k, s in enumerate(shape))
        raise ValueError("%s must have shape (%s)" % (name, ",".join(
            str(w) for w in want)))
    return a


# z-score of the standard-normal 99th percentile: mixture-component mass
# outside mean ± Z99·scale is <2%, so it bounds the default frequency axis
_Z99 = 2.3263478740408408


def plot_spectrum(means, scales, dataset=None, weights=None, noises=None,
                  method="LS", maxfreq=None, log=False, n=10000, titles=None,
                  show=True, filename=None, title=None):
    """Grid of spectral Gaussian-mixture densities, one subplot per
    (channel, input dim), optionally over each channel's data periodogram.

    Covers reference mogptk/util.py:130-234; rendering goes through
    mogptk_tpu_torch.plotting (mixture_psd + Canvas layers).
    """
    from . import plotting

    means = _mixture_arg(means, "means and scales", (None, None, None), 2)
    scales = _mixture_arg(scales, "means and scales", means.shape, 2)
    Q, output_dims, input_dims = means.shape
    if weights is None:
        weights = np.ones((Q, output_dims))
    else:
        weights = _mixture_arg(weights, "weights", (Q, output_dims), 1)
    if maxfreq is not None:
        maxfreq = _mixture_arg(maxfreq, "maxfreq", (output_dims, input_dims), 1)
    if noises is not None:
        noises = np.asarray(noises)
        if noises.ndim != 1 or noises.shape[0] != output_dims:
            raise ValueError("noises must have shape (output_dims,)")
    if dataset is not None and len(dataset) != output_dims:
        raise ValueError("means and scales must have %d output dimensions"
                         % len(dataset))

    fig, axes = plotting.grid(output_dims, input_dims, title=title)
    for j in range(output_dims):
        for i in range(input_dims):
            ax = axes[j, i]
            mu, sd = means[:, j, i], scales[:, j, i]

            # frequency axis: the mixture's own 1%-99% mass range, unless a
            # periodogram (whose own range wins) or maxfreq narrows it
            x_lo = max(0.0, float((mu - _Z99 * sd).min()))
            x_hi = float((mu + _Z99 * sd).max())
            if dataset is not None:
                mf = maxfreq[j, i] if maxfreq is not None else None
                dataset[j].plot_spectrum(ax=ax, method=method, transformed=True,
                                         n=n, log=False, maxfreq=mf)
                x_lo, x_hi = ax.get_xlim()
            if maxfreq is not None:
                x_hi = maxfreq[j, i]

            x = np.linspace(x_lo, x_hi, n)
            comps, total = plotting.mixture_psd(x, mu, sd, weights[:, j])
            if noises is not None:
                total = total + noises[j] ** 2
            # one common normalizer keeps components proportional to total
            scale = total.sum() * (x[1] - x[0])

            canvas = plotting.Canvas(ax)
            canvas.peaks(mu, "peak")
            for comp in comps:
                canvas.curve(x, comp / scale, "mixture")
            canvas.curve(x, total / scale, "model")

            y_lo = 0.0
            if log:
                x_lo, y_lo = max(x_lo, 1e-8), 1e-8
            y_hi = max(ax.get_ylim()[1], 1.05 * float(total.max()) / scale)
            canvas.finish(legend=False, logx=log, logy=log, hide_yticks=True,
                          title=None if titles is None else titles[j])
            ax.set_xlim(x_lo, x_hi)
            ax.set_ylim(y_lo, y_hi)

    axes[-1, -1].set_xlabel("Frequency")
    entries = [("psd", "Data (LombScargle)")] if dataset is not None else []
    plotting.figure_legend(fig, entries + [("model", "Model"),
                                           ("peak", "Peak location")])

    if filename is not None:
        import matplotlib.pyplot as plt
        plt.savefig(filename + ".pdf", dpi=300)
    if show:
        import matplotlib.pyplot as plt
        plt.show()
    return fig, axes
