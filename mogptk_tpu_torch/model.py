"""User-facing Model: glues a DataSet, a kernel and an inference scheme;
training, prediction, metrics, persistence and plots.

JAX counterpart: mogptk_tpu/model.py (`Exact` :80-105, `Model` :208-865);
reference mogptk/model.py:76-1037. Training runs gpr.train (torch.optim, one
synchronizing callback per step); prediction runs the gpr model's predict_y
on its device and hands numpy back. Ported: the `Exact` selector
(closed-form gradient by default, probe-trace with trace_probes),
save/LoadModel, the metrics and the plots. Not ported yet: the sparse and iterative selectors (construction
raises NotImplementedError naming the ROADMAP item), sampling, and the XLA
compilation-cache priming (`precompile`, which has no counterpart here).
"""
import inspect
import logging
import math
import os
import time

import numpy as np
import torch

from . import gpr
from .dataset import DataSet
from .util import (mean_absolute_error, mean_absolute_percentage_error,
                   symmetric_mean_absolute_percentage_error,
                   mean_squared_error, root_mean_squared_error)

logger = logging.getLogger("mogptk_tpu_torch")


def LoadModel(filename, device=None):
    """Load a model saved with model.save() (reference: mogptk/model.py:62-74).
    Its tensors are put on `device` (None = gpr.config.device)."""
    device = gpr.resolve_device(device)
    model = torch.load(filename + ".npy", map_location=device, weights_only=False)
    model.gpr.device = device
    return model


class Exact:
    """Exact inference selector (reference: mogptk/model.py:76-100).

    trace_probes: None for the deterministic closed-form gradient; an int R
    for Hutchinson probe-trace gradients."""

    def __init__(self, variance=None, data_variance=None, jitter=1e-8, trace_probes=None):
        self.variance = variance
        self.data_variance = data_variance
        self.jitter = jitter
        self.trace_probes = trace_probes

    def _build(self, kernel, x, y, y_err=None, mean=None, device=None):
        variance = self.variance
        if variance is None:
            variance = [1.0] * kernel.output_dims if kernel.output_dims is not None else 1.0
        data_variance = self.data_variance
        if data_variance is None and y_err is not None:
            data_variance = y_err ** 2
        return gpr.Exact(kernel, x, y, variance=variance, data_variance=data_variance,
                         jitter=self.jitter, mean=mean, trace_probes=self.trace_probes,
                         device=device)


class _Unported:
    """An inference selector that is not ported yet: constructing it raises."""
    item = None

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("%s inference is not ported yet (ROADMAP queue 1, item %d)"
                                  % (type(self).__name__, self.item))


class Snelson(_Unported):
    item = 7


class OpperArchambeau(_Unported):
    item = 7


class Titsias(_Unported):
    item = 7


class Hensman(_Unported):
    item = 7


class Iterative(_Unported):
    item = 5


class Model:
    """Multi-output GP model over a DataSet (reference: mogptk/model.py:180-1037).

    Attributes:
        dataset: The DataSet.
        gpr: The underlying gpr.Model, on `device` (None = gpr.config.device).
        times, losses, errors: Per-iteration training history arrays.
    """

    def __init__(self, dataset, kernel, inference=None, mean=None, name=None,
                 rescale_x=False, device=None):
        if inference is None:
            inference = Exact()
        if not isinstance(dataset, DataSet):
            dataset = DataSet(dataset)
        if dataset.get_output_dims() == 0:
            raise ValueError("dataset must have at least one channel")
        names = [n for n in dataset.get_names() if n is not None]
        if len(set(names)) != len(names):
            raise ValueError("all data channels must have unique names")

        self.name = name
        self.dataset = dataset
        self.is_multioutput = kernel.output_dims is not None

        X, Y = self.dataset.get_train_data()
        # rescale_x: see mogptk_tpu/model.py Model.__init__ (True/"center"
        # subtracts the per-dim training mean, "normalize" also divides by the
        # per-dim training std; the model families convert their data-unit
        # initial estimates with _x_to_kernel_units)
        self._x_offset = None
        self._x_scale = None
        if rescale_x:
            allx = np.concatenate([np.asarray(Xj, dtype=np.float64) for Xj in X], axis=0)
            self._x_offset = allx.mean(axis=0)
            if rescale_x not in (True, "center"):
                if rescale_x not in ("normalize", "norm"):
                    raise ValueError("rescale_x must be False, True/'center', or 'normalize'; "
                                     "got %r" % (rescale_x,))
                std = allx.std(axis=0)
                self._x_scale = np.where(std > 0.0, std, 1.0)
        x, y = self._to_kernel_format(X, Y)

        y_err = None
        if all(channel.Y_err is not None for channel in self.dataset):
            Y_err = [channel.Y_err[channel.mask] for channel in self.dataset]
            Y_tr = [channel.Y[channel.mask] for channel in self.dataset]
            Y_err_lower = [self.dataset[j].Y_transformer.forward(Y_tr[j] - Y_err[j], X[j])
                           for j in range(len(self.dataset))]
            Y_err_upper = [self.dataset[j].Y_transformer.forward(Y_tr[j] + Y_err[j], X[j])
                           for j in range(len(self.dataset))]
            y_err = (np.concatenate(Y_err_upper, axis=0) - np.concatenate(Y_err_lower, axis=0)) / 2.0

        self.gpr = inference._build(kernel, x, y, y_err, mean, device)

        self.iters = 0
        self.times = np.zeros(0)
        self.losses = np.zeros(0)
        self.errors = np.zeros(0)

    # -- introspection -------------------------------------------------------
    def __str__(self):
        s = "Model: %s\n" % self.gpr.name()
        s += "- Kernel: %s\n" % self.gpr.kernel.name()
        s += "- Likelihood: %s\n" % self.gpr.likelihood.name()
        s += "- Parameters: %d\n" % self.num_parameters()
        for name, p in zip(gpr.parameter_names(self.gpr), self.parameters()):
            s += "  - %s %s\n" % (name, tuple(p.shape))
        s += "- Channels: %d\n" % len(self.dataset)
        s += "- Training points: %d\n" % self.num_training_points()
        return s

    def print_parameters(self, file=None):
        """Print each parameter's name and value (reference:
        gpr/model.py:188-240, the plain-text table)."""
        rows = [("Name", "Value")] + [(name, p.numpy().tolist()) for name, p in
                                      zip(gpr.parameter_names(self.gpr), self.parameters())]
        width = max(len(r[0]) for r in rows)
        for name, value in rows:
            print("%-*s  %s" % (width, name, value), file=file)

    def parameters(self):
        """The gpr model's Parameters, in registration order."""
        return [p for _, p in self.gpr.gp_parameters()]

    def get_parameters(self):
        print("DEPRECATED: use model.parameters() instead of model.get_parameters()")
        return self.parameters()

    def copy_parameters(self, other):
        print("DEPRECATED: use model.load_kernel_parameters() instead of model.copy_parameters()")
        self.load_kernel_parameters(other)

    def load_kernel_parameters(self, other):
        """Warm-start: copy kernel parameter values from another model
        (reference: mogptk/model.py:282-294)."""
        if not isinstance(other, Model):
            raise ValueError("other must be of type Model")
        if type(self.gpr.kernel) is not type(other.gpr.kernel):
            raise ValueError("other must have the same kernel")
        mine = [p for _, p in self.gpr.kernel.gp_parameters()]
        theirs = [p for _, p in other.gpr.kernel.gp_parameters()]
        if len(mine) != len(theirs):
            raise ValueError("kernels must have the same number of parameters")
        if any(p.shape != q.shape for p, q in zip(mine, theirs)):
            raise ValueError("kernel parameters must have matching shapes")
        with torch.no_grad():
            for p, q in zip(mine, theirs):
                p.raw.copy_(q.raw)

    def num_parameters(self):
        return sum(p.raw.numel() for p in self.parameters() if p.train)

    def num_training_points(self):
        return sum(len(channel.get_train_data()[1]) for channel in self.dataset)

    def save(self, filename):
        """Save the whole model to <filename>.npy (reference:
        mogptk/model.py:320-336), with torch.save: LoadModel puts its
        tensors on the device it is asked for."""
        filename += ".npy"
        try:
            os.remove(filename)
        except OSError:
            pass
        torch.save(self, filename)

    def log_marginal_likelihood(self):
        """The model's log marginal likelihood, a float."""
        with torch.no_grad():
            return float(self.gpr.log_marginal_likelihood())

    def BIC(self):
        """Bayesian information criterion (reference: mogptk/model.py:350-360)."""
        return self.num_parameters() * np.log(self.num_training_points()) - 2.0 * self.log_marginal_likelihood()

    def AIC(self):
        """Akaike information criterion (reference: mogptk/model.py:362-372)."""
        return 2.0 * self.num_parameters() - 2.0 * self.log_marginal_likelihood()

    def loss(self):
        with torch.no_grad():
            return float(self.gpr.loss())

    def error(self, method="MAE", use_all_data=False):
        """Prediction error on the removed (test) points
        (reference: mogptk/model.py:386-439)."""
        if callable(method) and len(inspect.signature(method).parameters) == 1:
            return method(self)

        if use_all_data or not any(self.dataset.has_test_data()):
            X, Y_true = self.dataset.get_data()
        else:
            X, Y_true = self.dataset.get_test_data()

        y_pred = self.gpr.predict_y(self._to_kernel_format(X)).cpu().numpy()
        i = 0
        Y_pred = []
        for j in range(self.dataset.get_output_dims()):
            N = X[j].shape[0]
            Y_pred.append(self.dataset[j].Y_transformer.backward(y_pred[i:i + N].reshape(-1), X[j]))
            i += N

        y_true = np.concatenate(Y_true)
        y_pred = np.concatenate(Y_pred)
        metrics = {"mae": mean_absolute_error, "mape": mean_absolute_percentage_error,
                   "smape": symmetric_mean_absolute_percentage_error,
                   "mse": mean_squared_error, "rmse": root_mean_squared_error}
        if callable(method):
            return method(y_true, y_pred)
        if method.lower() not in metrics:
            raise ValueError("valid error calculation methods are MAE, MAPE, sMAPE, MSE, and RMSE")
        return metrics[method.lower()](y_true, y_pred)

    def train(self, method="Adam", iters=500, verbose=False, error=None, plot=False, **kwargs):
        """Optimize the kernel and likelihood hyperparameters
        (reference: mogptk/model.py:441-579) with gpr.train.

        Returns:
            (losses, errors): per-iteration arrays of length iters+1.
        """
        error_use_all_data = False
        if error is not None and all(not channel.has_test_data() for channel in self.dataset):
            error_use_all_data = True

        names = {"l-bfgs": "LBFGS", "lbfgs": "LBFGS", "l-bfgs-b": "LBFGS", "lbfgsb": "LBFGS",
                 "adam": "Adam", "sgd": "SGD", "adagrad": "AdaGrad"}
        if method.lower() not in names:
            raise ValueError("optimizer must be LBFGS, Adam, SGD, or AdaGrad")
        method = names[method.lower()]

        if verbose:
            print("Starting optimization using", method)
            print("- Model: %s" % self.gpr.name())
            print("  - Kernel: %s" % self.gpr.kernel.name())
            print("  - Likelihood: %s" % self.gpr.likelihood.name())
            print("- Channels: %d" % len(self.dataset))
            print("- Parameters: %d" % self.num_parameters())
            print("- Training points: %d" % self.num_training_points())
            print("- Iterations: %d" % iters)

        iters = int(iters)
        iter_offset = 0
        times = np.zeros((iters + 1,))
        losses = np.zeros((iters + 1,))
        errors = np.zeros((iters + 1,))
        if self.times.shape[0] != 0:
            iter_offset = self.times.shape[0] - 1
            times = np.concatenate((self.times[:-1], times))
            losses = np.concatenate((self.losses[:-1], losses))
            errors = np.concatenate((self.errors[:-1], errors))
        initial_time = time.time()

        losses[iter_offset] = self.loss()
        times[iter_offset] = time.time() - initial_time
        if error is not None:
            errors[iter_offset] = float(self.error(error, error_use_all_data))

        def callback(i, loss):
            idx = iter_offset + 1 + i
            times[idx] = time.time() - initial_time
            if error is not None:
                errors[idx] = float(self.error(error, error_use_all_data))
            if verbose and (i % max(1, iters // 10) == 0 or i == iters - 1):
                msg = "  %d/%d %s  loss=%12g" % (i + 1, iters, _format_time(times[idx]), loss)
                if error is not None:
                    msg += "  error=%12g" % errors[idx]
                print(msg)

        step_losses, _ = gpr.train(self.gpr, method=method, lr=kwargs.pop("lr", None),
                                   iters=iters, callback=callback, **kwargs)
        n_done = len(step_losses)
        losses[iter_offset + 1: iter_offset + 1 + n_done] = step_losses

        if verbose:
            print("Optimization finished in %s" % _format_duration(time.time() - initial_time))

        self.iters = iter_offset + n_done
        self.times = times[: iter_offset + n_done + 1]
        self.losses = losses[: iter_offset + n_done + 1]
        if error is not None:
            self.errors = errors[: iter_offset + n_done + 1]
        if plot:
            self.plot_losses()
        return losses, errors

    # -- x-unit conversion (rescale_x="normalize") ----------------------------
    def _x_unit_factor(self, xpow, scalar=False):
        """Multiplier taking a data-unit x^xpow quantity into kernel units
        (see mogptk_tpu/model.py Model._x_unit_factor)."""
        s = getattr(self, "_x_scale", None)
        if s is None:
            return 1.0
        s = np.exp(np.mean(np.log(s))) if scalar else np.asarray(s)
        return s ** (-xpow)

    def _x_to_kernel_units(self, value, xpow, absolute=False, scalar=False):
        """Convert a data-unit estimate into kernel-x units; the identity
        unless the model was built with rescale_x='normalize'."""
        value = np.asarray(value, dtype=np.float64)
        if absolute and getattr(self, "_x_offset", None) is not None:
            value = value - self._x_offset
        return value * self._x_unit_factor(xpow, scalar=scalar)

    def _x_from_kernel_units(self, value, xpow, absolute=False, scalar=False):
        """Inverse of _x_to_kernel_units."""
        value = np.asarray(value, dtype=np.float64) / self._x_unit_factor(xpow, scalar=scalar)
        if absolute and getattr(self, "_x_offset", None) is not None:
            value = value + self._x_offset
        return value

    # -- prediction -----------------------------------------------------------
    def _to_kernel_format(self, X, Y=None):
        """Concatenate per-channel data and prepend channel IDs for
        multi-output kernels (reference: mogptk/model.py:585-606)."""
        x = np.concatenate([np.asarray(Xj, dtype=np.float64) for Xj in X], axis=0)
        if getattr(self, "_x_offset", None) is not None:
            x = x - self._x_offset
        if getattr(self, "_x_scale", None) is not None:
            x = x / self._x_scale
        if self.is_multioutput:
            chan = np.concatenate([j * np.ones(len(X[j])) for j in range(len(X))]).reshape(-1, 1)
            x = np.concatenate([chan, x], axis=1)
        if Y is None:
            return x
        Y = list(Y)
        for j in range(len(Y)):
            Y[j] = self.dataset[j].Y_transformer.forward(Y[j], X[j])
        return x, np.concatenate(Y, axis=0).reshape(-1, 1)

    def _rescale_kernel_x(self, X):
        """Apply the rescale_x affine to an already kernel-formatted array
        (channel column, if any, untouched)."""
        off = getattr(self, "_x_offset", None)
        sc = getattr(self, "_x_scale", None)
        if off is None and sc is None:
            return X
        X = np.array(X, dtype=np.float64, copy=True)
        cols = slice(1, None) if self.is_multioutput else slice(None)
        if off is not None:
            X[:, cols] = X[:, cols] - off
        if sc is not None:
            X[:, cols] = X[:, cols] / sc
        return X

    def _gram(self, x1, x2=None):
        """The kernel's Gram between kernel-formatted arrays, as numpy."""
        def dev(x):
            return torch.as_tensor(x, dtype=gpr.config.dtype, device=self.gpr.device)
        with torch.no_grad():
            K = self.gpr.kernel(dev(x1), None if x2 is None else dev(x2))
        return K.cpu().numpy()

    def predict(self, X=None, ci=None, sigma=2, n=10000, transformed=False):
        """Predict mean and confidence bounds per channel, inverting the data
        transformations (reference: mogptk/model.py:608-664). `n` (Monte
        Carlo samples of non-Gaussian likelihoods) is unused: the Gaussian
        likelihood's bands are closed-form."""
        if X is None:
            X = self.dataset.get_prediction_data()
        else:
            X = self.dataset._format_X(X)
        x = self._to_kernel_format(X)

        if isinstance(ci, float):
            ci = (1.0 - ci) / 2.0
            ci = [ci, 1.0 - ci]
        if ci is not None:
            ci = [max(0.0, ci[0]), min(1.0, ci[1])]

        out = self.gpr.predict_y(x, ci, sigma=sigma)
        if not isinstance(out, tuple):
            out = (out, out, out)
        mu, lower, upper = (t.cpu().numpy() for t in out)

        i = 0
        Mu, Lower, Upper = [], [], []
        for j in range(self.dataset.get_output_dims()):
            N = X[j].shape[0]
            Mu.append(mu[i:i + N].reshape(-1))
            Lower.append(lower[i:i + N].reshape(-1))
            Upper.append(upper[i:i + N].reshape(-1))
            i += N

        if not transformed:
            for j in range(self.dataset.get_output_dims()):
                Mu[j] = self.dataset[j].Y_transformer.backward(Mu[j], X[j])
                Lower[j] = self.dataset[j].Y_transformer.backward(Lower[j], X[j])
                Upper[j] = self.dataset[j].Y_transformer.backward(Upper[j], X[j])

        if len(self.dataset) == 1:
            return X[0], Mu[0], Lower[0], Upper[0]
        return X, Mu, Lower, Upper

    def K(self, X1, X2=None):
        """Kernel matrix between channel-formatted inputs, as numpy
        (reference: mogptk/model.py:666-690)."""
        x1 = self._to_kernel_format(self.dataset._format_X(X1))
        if X2 is None:
            return self._gram(x1)
        return self._gram(x1, self._to_kernel_format(self.dataset._format_X(X2)))

    def sample(self, X=None, n=None, prior=False, transformed=False):
        """Sampling from the posterior or prior is not ported yet."""
        raise NotImplementedError("sampling is not ported yet (ROADMAP queue 1, item 8)")

    # -- plotting ---------------------------------------------------------------
    # Data preparation only; rendering goes through plotting.py
    # (covers reference mogptk/model.py:736-1037).

    def _per_channel(self, val, default):
        """Expand a scalar (or None) to one value per output channel."""
        if val is None:
            val = default
        if not isinstance(val, (list, np.ndarray)):
            val = [val] * len(self.dataset)
        return val

    def plot_losses(self, title=None, figsize=(12, 4), legend=True, errors=True, log=False):
        """Plot the training loss (and, on a twin axis, error) history."""
        from . import plotting
        if self.iters == 0:
            raise Exception("must be trained in order to plot the losses")

        fig, axes = plotting.grid(1, 1, figsize=figsize, title=title)
        ax = axes[0, 0]
        it = np.arange(self.iters + 1)
        canvas = plotting.Canvas(ax)
        canvas.curve(it, self.losses, "loss", "Loss")
        if errors and it.shape[0] == self.errors.shape[0]:
            twin = plotting.Canvas(ax.twinx(), legend_into=canvas)
            twin.curve(it, self.errors, "error", "Error")
            twin.finish(ylabel="Error", legend=False, logy=log, label_size=10)
            twin.ax.set_ylim(0.0, None)
        ax.set_xlim(0, self.iters)
        canvas.finish(xlabel="Iteration", ylabel="Loss", legend=legend, logy=log, label_size=10)
        return fig, ax

    def plot_prediction(self, X=None, title=None, figsize=None, legend=True,
                        errorbars=True, ci=None, sigma=2, n=10000, transformed=False):
        """Plot per-channel posterior mean and confidence band over the data."""
        from . import plotting

        X, Mu, Lower, Upper = self.predict(X, ci=ci, sigma=sigma, n=n, transformed=transformed)
        if len(self.dataset) == 1:
            X, Mu, Lower, Upper = [X], [Mu], [Lower], [Upper]

        fig, axes = plotting.grid(len(self.dataset), 1, figsize=figsize)
        for j, data in enumerate(self.dataset):
            data._require_plottable()
            canvas = plotting.Canvas(axes[j, 0], x_dtype=data._axis_dtype())

            order = np.argsort(X[j][:, 0])
            xs = X[j][order, 0]
            mu = Mu[j][order]
            lo, hi = Lower[j][order], Upper[j][order]
            if not (np.all(lo == mu) and np.all(hi == mu)):
                canvas.band(xs, lo, hi, "band", "95% CI")
            canvas.curve(xs, mu, "mean", "Posterior mean")

            xmin, xmax = data._push_observations(canvas, transformed=transformed,
                                                 errorbars=errorbars)
            canvas.finish(xlim=(min(xmin, xs.min()), max(xmax, xs.max())),
                          xlabel=data.X_labels[0], ylabel=data.Y_label,
                          title=data.name if title is None else title,
                          legend=legend, label_size=10, title_size=14)
        return fig, axes

    def plot_gram(self, start=None, end=None, n=31, title=None, figsize=(12, 12)):
        """Heatmap of the Gram matrix on an n-point grid per channel."""
        from . import plotting
        if not all(channel.get_input_dims() == 1 for channel in self.dataset):
            raise ValueError("cannot plot for more than one input dimension")

        start = self._per_channel(start, [c.X.min() for c in self.dataset])
        end = self._per_channel(end, [c.X.max() for c in self.dataset])

        output_dims = len(self.dataset)
        grids = [np.full(n, 0.5 * (s + e)) if n == 1 else np.linspace(s, e, n)
                 for s, e in zip(start, end)]
        X = np.stack([np.repeat(np.arange(output_dims, dtype=np.float64), n),
                      np.concatenate(grids)], axis=1)
        if not self.is_multioutput:
            X = X[:, 1:]
        K = self._gram(self._rescale_kernel_x(X))

        fig, axes = plotting.grid(1, 1, figsize=figsize, title=title)
        plotting.heatmap(fig, axes[0, 0], K, block=n)
        return fig, axes[0, 0]

    def plot_kernel(self, dist=None, n=101, title=None, figsize=(12, 12)):
        """Plot k(τ) for every channel pair on a lower-triangular grid."""
        from . import plotting
        if not all(channel.get_input_dims() == 1 for channel in self.dataset):
            raise ValueError("cannot plot for more than one input dimension")

        dist = self._per_channel(dist, [(c.X.max() - c.X.min()) / 4.0 for c in self.dataset])

        output_dims = len(self.dataset)
        fig, axes = plotting.grid(output_dims, output_dims, figsize=figsize,
                                  title=title, sharex=True)
        for j in range(output_dims):
            tau = np.linspace(-dist[j], dist[j], num=n).reshape(-1, 1)
            for i in range(output_dims):
                if j < i:
                    axes[j, i].set_axis_off()
                    continue
                if self.is_multioutput:
                    left = np.concatenate((np.full((n, 1), float(i)), tau), axis=1)
                    right = np.array([[float(j), 0.0]])
                else:
                    left, right = tau, np.array([[0.0]])
                k = self._gram(self._rescale_kernel_x(left), self._rescale_kernel_x(right))
                canvas = plotting.Canvas(axes[j, i])
                canvas.curve(tau[:, 0], k[:, 0], "kernel")
                canvas.finish(legend=False, hide_yticks=True)
        return fig, axes

    def plot_correlation(self, title=None, figsize=(12, 12)):
        """Heatmap of the cross-channel correlation matrix at x = 0."""
        from . import plotting
        output_dims = len(self.dataset)
        X = np.zeros((output_dims, 2))
        X[:, 0] = np.arange(output_dims)
        K = self._gram(self._rescale_kernel_x(X))
        d = np.sqrt(np.diag(K))
        C = K / np.outer(d, d)

        fig, axes = plotting.grid(1, 1, figsize=figsize, title=title)
        plotting.heatmap(fig, axes[0, 0], C, vmin=-1.0, vmax=1.0,
                         colorbar=False, cell_text=True,
                         tick_labels=self.dataset.get_names())
        return fig, axes[0, 0]


def _format_duration(s):
    if s < 60.0:
        return "%.3f seconds" % s
    s = math.floor(s)
    days = int(s / 86400)
    hours = int(s % 86400 / 3600)
    minutes = int(s % 3600 / 60)
    seconds = int(s % 60)
    duration = ""
    for num, word in ((days, "day"), (hours, "hour"), (minutes, "minute"), (seconds, "second")):
        if num == 1:
            duration += " 1 %s" % word
        elif 1 < num:
            duration += " %d %ss" % (num, word)
    return duration[1:]


def _format_time(s):
    return "%3d:%02d:%02d" % (int(s / 3600), int((s % 3600) / 60), int(s % 60))
