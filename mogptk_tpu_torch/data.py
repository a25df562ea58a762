"""Per-channel data container: observations, train/test masks, prediction
ranges, datetime handling, and spectral estimation.

Capability parity with mogptk/data.py (Data 197-1313, LoadSplitData 24-76,
LoadFunction 78-191, duration parsing 1349-1413, datetime64 helpers
1415-1445). Pure NumPy/pandas host-side code; only the estimation methods
touch the GPR core. A copy of mogptk_tpu/data.py, kept in this package so that
it imports nothing of the JAX package, with three changes: the random draws
come from this package's gpr.config, torch tensors (CUDA ones too) convert to
numpy, and BNSE comes from this package's init.py. The SM-model spectral
estimate raises until the SM model is ported.
"""
import re
import copy
import inspect
import datetime
import logging
import collections

import numpy as np

from .transformer import Transformer

logger = logging.getLogger("mogptk_tpu_torch")


def LoadSplitData(x_train, x_test, y_train, y_test, name=""):
    """Load a pre-split train/test set into a Data object; the test portion is
    marked as removed (reference: mogptk/data.py:24-76)."""
    x_train = np.asarray(x_train)
    x_test = np.asarray(x_test)
    y_train = np.asarray(y_train)
    y_test = np.asarray(y_test)
    if x_train.ndim == 1:
        x_train = x_train.reshape(-1, 1)
    if x_test.ndim == 1:
        x_test = x_test.reshape(-1, 1)
    if y_train.ndim == 2 and y_train.shape[1] == 1:
        y_train = y_train.reshape(-1)
    if y_test.ndim == 2 and y_test.shape[1] == 1:
        y_test = y_test.reshape(-1)

    if x_train.ndim != 2 or x_test.ndim != 2:
        raise ValueError("x data must have shape (data_points,input_dims)")
    if y_train.ndim != 1 or y_test.ndim != 1:
        raise ValueError("y data must have shape (data_points,)")
    if x_train.shape[0] != y_train.shape[0]:
        raise ValueError("x_train and y_train must have the same number of data points")
    if x_test.shape[0] != y_test.shape[0]:
        raise ValueError("x_test and y_test must have the same number of data points")
    if x_train.shape[1] != x_test.shape[1]:
        raise ValueError("x_train and x_test must have the same number of input dimensions")

    x = np.concatenate((x_train, x_test))
    y = np.concatenate((y_train, y_test))
    test_indices = np.arange(len(x_train), len(x))

    data = Data(x, y, name=name)
    data.remove_indices(test_indices)
    return data


def LoadFunction(f, start, end, n, var=0.0, name="", random=False):
    """Sample a dataset from y = f(x) + N(0, var) over [start, end]
    (reference: mogptk/data.py:78-191). Supports datetime64 axes and
    meshgrid-style multi-input sampling."""
    def _to_list(v):
        if isinstance(v, np.ndarray):
            return [v.item()] if v.ndim == 0 else list(v)
        elif _is_iterable(v):
            return list(v)
        return [v]

    start = _to_list(start)
    end = _to_list(end)
    if type(start[0]) is not type(end[0]):
        raise ValueError("start and end must be of the same type")
    if len(start) != len(end):
        raise ValueError("start and end must be of the same length")

    input_dims = len(start)
    for i in range(input_dims):
        if isinstance(start[i], (datetime.datetime, str, np.datetime64)):
            try:
                start[i] = np.datetime64(start[i], "us")
                end[i] = np.datetime64(end[i], "us")
            except Exception:
                raise ValueError("start and end must have matching number or datetime data type")
        else:
            try:
                start[i] = np.float64(start[i])
                end[i] = np.float64(end[i])
            except Exception:
                raise ValueError("start and end must have matching number or datetime data type")

    _check_function(f, input_dims, [isinstance(start[i], np.datetime64) for i in range(input_dims)])

    n = _to_list(n) if _is_iterable(n) else [n] * input_dims
    if len(n) != input_dims:
        raise ValueError("n must be a scalar or a list of values for each input dimension")
    random = _to_list(random) if _is_iterable(random) else [random] * input_dims
    if len(random) != input_dims:
        raise ValueError("random must be a scalar or a list of values for each input dimension")

    for i in range(input_dims):
        if random[i] and isinstance(start[i], np.datetime64):
            raise ValueError("cannot use random for datetime inputs")

    from .gpr.config import config as _cfg
    rng = _cfg.numpy_rng()
    x = [None] * input_dims
    for i in range(input_dims):
        if start[i] >= end[i]:
            raise ValueError("start must be lower than end" +
                             ("" if input_dims == 1 else " for input dimension %d" % i))

        if isinstance(start[i], np.datetime64):
            dt = (end[i] - start[i]) / float(n[i] - 1)
            dt = _timedelta64_to_higher_unit(dt)
            x[i] = np.arange(start[i], start[i] + dt * (n[i] - 1) + np.timedelta64(1, "us"), dt, dtype=start[i].dtype)
        elif random[i]:
            x[i] = start[i] + (end[i] - start[i]) * rng.random(n[i])
        else:
            x[i] = np.linspace(start[i], end[i], n[i])

        N_tile = int(np.prod(n[:i])) if i > 0 else 1
        N_repeat = int(np.prod(n[i + 1:])) if i < input_dims - 1 else 1
        x[i] = np.tile(np.repeat(x[i], N_repeat), N_tile)

    y = f(*x)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    N = int(np.prod(n))
    if var != 0.0:
        y = y + rng.normal(0.0, np.sqrt(var), size=(N,))

    data = Data(x, y, name=name)
    data.set_function(f)
    return data


class Data:
    """Single-channel observations with train/test mask and prediction range
    (reference: mogptk/data.py:197-1313)."""

    def __init__(self, X, Y, Y_err=None, name=None, x_labels=None, y_label=None):
        if x_labels is not None:
            if isinstance(x_labels, str):
                x_labels = [x_labels]
            if not isinstance(x_labels, list) or not all(isinstance(label, str) for label in x_labels):
                raise ValueError("x_labels must be a string or list of strings for each input dimension")

            if isinstance(X, dict):
                it = iter(X.values())
                first = len(next(it))
                if not all(isinstance(x, (list, np.ndarray)) for x in X.values()) or not all(len(x) == first for x in it):
                    raise ValueError("X dict should contain all lists or numpy.ndarrays where each has the same length")
                if not all(key in X for key in x_labels):
                    raise ValueError("X dict must contain all keys listed in x_labels")
                X = [X[key] for key in x_labels]

        # meshgrid input (a list of D coordinate grids from np.meshgrid,
        # each shaped like Y): flatten BEFORE formatting. The reference
        # checks after its transpose, where the condition can never match a
        # real meshgrid (and produced a list when it did fire) — fixed.
        if (isinstance(X, list) and 0 < len(X)
                and all(isinstance(x, np.ndarray) and 1 < x.ndim for x in X)
                and all(x.shape == np.asarray(Y).shape for x in X)):
            X = [np.ravel(x) for x in X]
            Y = np.ravel(np.asarray(Y))
            if Y_err is not None:
                Y_err = np.ravel(np.asarray(Y_err))

        X, X_dtypes = self._format_X(X)
        Y = self._format_Y(Y)
        if Y_err is not None:
            Y_err = self._format_Y(Y_err)

        if X.ndim != 2:
            raise ValueError("X must have shape (data_points,input_dims)")
        if Y.ndim != 1:
            raise ValueError("Y must have shape (data_points,)")
        if Y.shape[0] == 0:
            raise ValueError("X and Y must have a length greater than zero")
        if X.shape[0] != Y.shape[0]:
            raise ValueError("X and Y must be of the same length")
        if Y_err is not None and Y.shape != Y_err.shape:
            raise ValueError("Y and Y_err must have the same shape")

        self.X = X
        self.Y = Y
        self.Y_err = Y_err
        self.X_pred = None
        self.mask = np.ones(Y.shape[0], dtype=bool)
        self.F = None

        self.X_dtypes = X_dtypes
        self.Y_transformer = Transformer()

        input_dims = X.shape[1]
        self.removed_ranges = [[] for _ in range(input_dims)]
        self.X_labels = ["X"] * input_dims
        if 1 < input_dims:
            for i in range(input_dims):
                self.X_labels[i] = "X%d" % (i,)
        if isinstance(x_labels, list) and all(isinstance(item, str) for item in x_labels):
            self.X_labels = x_labels

        self.name = None
        if isinstance(name, str):
            self.name = name
        elif isinstance(y_label, str):
            self.name = y_label

        self.Y_label = "Y"
        if isinstance(y_label, str):
            self.Y_label = y_label

    # -- input coercion ------------------------------------------------------
    def _format_X(self, X):
        import pandas as pd
        if isinstance(X, list) and 0 < len(X):
            islist = False
            if all(isinstance(x, list) for x in X):
                islist = True
                m = len(X[0])
                if not all(len(x) == m for x in X[1:]):
                    raise ValueError("X list items must all be lists of the same length")
                if not all(all(isinstance(val, (int, float, datetime.datetime, np.datetime64)) for val in x) for x in X):
                    raise ValueError("X list items must all be lists of numbers or datetime")
                if not all(_is_homogeneous_type(x) for x in X):
                    raise ValueError("X list items must all be lists with elements of the same type")
            elif all(hasattr(x, "__len__") and not isinstance(x, str) for x in X):
                islist = True
                m = len(X[0])
                if not all(len(x) == m for x in X[1:]):
                    raise ValueError("X list items must all be arrays of the same length")
            elif not all(isinstance(x, (int, float, datetime.datetime, np.datetime64)) for x in X):
                raise ValueError("X list items must be all lists, all numpy.ndarrays, or all numbers or datetime")
            elif not _is_homogeneous_type(X):
                raise ValueError("X list items must all have elements of the same type")

            if islist:
                X = [np.array(x) for x in X]
            else:
                X = [np.array(X)]
        elif isinstance(X, (np.ndarray, pd.Series)) or _is_tensor(X):
            X = _to_numpy(X)
            if X.ndim == 1:
                X = X.reshape(-1, 1)
            if X.ndim != 2:
                raise ValueError("X must be either a one or two dimensional array of data")
            X = [X[:, i] for i in range(X.shape[1])]
        else:
            raise ValueError("X must be list, numpy.ndarray, pandas.Series, or tensor")

        input_dims = len(X)
        if hasattr(self, "X_dtypes"):
            if input_dims != len(self.X_dtypes):
                raise ValueError("X must have %d input dimensions" % (len(self.X_dtypes),))
            for i in range(input_dims):
                try:
                    X[i] = X[i].astype(self.X_dtypes[i])
                except Exception:
                    raise ValueError("X data must have valid data types for each input dimension")
        else:
            for i in range(input_dims):
                if X[i].dtype == np.object_ or np.issubdtype(X[i].dtype, np.character):
                    try:
                        X[i] = X[i].astype(np.datetime64)
                    except Exception:
                        raise ValueError("X data must have a number or datetime data type")
                elif not np.issubdtype(X[i].dtype, np.datetime64):
                    try:
                        X[i] = X[i].astype(np.float64)
                    except Exception:
                        raise ValueError("X data must have a number or datetime data type")

                if np.issubdtype(X[i].dtype, np.datetime64):
                    X[i] = _datetime64_to_higher_unit(X[i])

        dtypes = [x.dtype for x in X]
        X = np.array([x.astype(np.float64) for x in X]).T
        if X.size == 0:
            raise ValueError("X data must not be empty")
        if not np.isfinite(X).all():
            raise ValueError("X data must not contains NaNs or infinities")
        return X, dtypes

    def _format_Y(self, Y):
        import pandas as pd
        if isinstance(Y, list):
            if not all(isinstance(y, (int, float)) for y in Y):
                raise ValueError("Y list items must all be numbers")
            elif not _is_homogeneous_type(Y):
                raise ValueError("Y list items must all have elements of the same type")
            Y = np.array(Y)
        elif isinstance(Y, pd.Series):
            Y = Y.to_numpy()
        elif _is_tensor(Y):
            Y = _to_numpy(Y)
        elif not isinstance(Y, np.ndarray):
            raise ValueError("Y must be list, numpy.ndarray, pandas.Series, or tensor")

        try:
            Y = Y.astype(np.float64)
        except Exception:
            raise ValueError("Y data must have a number data type")

        if Y.ndim == 2 and Y.shape[1] == 1:
            Y = Y.reshape(-1)
        if Y.shape[0] == 0:
            raise ValueError("Y data must not be empty")
        if not np.isfinite(Y).all():
            raise ValueError("Y data must not contains NaNs or infinities")
        return Y

    def __repr__(self):
        import pandas as pd
        df = pd.DataFrame()
        for i in range(self.X.shape[1]):
            df[self.X_labels[i]] = self.X[:, i]
        df[self.Y_label] = self.Y
        return repr(df)

    def copy(self):
        """Deep copy (reference: mogptk/data.py:397-407)."""
        return copy.deepcopy(self)

    def set_name(self, name):
        self.name = name

    def set_labels(self, x_labels, y_label):
        """Set axis labels for plots (reference: mogptk/data.py:421-442)."""
        if isinstance(x_labels, str):
            x_labels = [x_labels]
        elif not isinstance(x_labels, list) or not all(isinstance(item, str) for item in x_labels):
            raise ValueError("x_labels must be list of strings")
        if not isinstance(y_label, str):
            raise ValueError("y_label must be string")
        if len(x_labels) != self.get_input_dims():
            raise ValueError("x_labels must have the same input dimensions as the data")
        self.X_labels = x_labels
        self.Y_label = y_label

    def set_function(self, f):
        """Set the latent/true function for plotting (reference: mogptk/data.py:444-455)."""
        _check_function(f, self.get_input_dims(),
                        [_is_datetime64(self.X_dtypes[i]) for i in range(self.get_input_dims())])
        self.F = f

    def transform(self, transformer):
        """Append a Y transformation (reference: mogptk/data.py:457-471)."""
        self.Y_transformer.append(transformer, self.Y, self.X)

    def filter(self, start, end, dim=None):
        """Keep only data with X in [start, end) (reference: mogptk/data.py:473-501)."""
        start = self._normalize_x_val(start, dim=dim)
        end = self._normalize_x_val(end, dim=dim)

        if dim is not None:
            ind = np.logical_and(self.X[:, dim] >= start[dim], self.X[:, dim] < end[dim])
        else:
            ind = np.logical_and(self.X[:, 0] >= start[0], self.X[:, 0] < end[0])
            for i in range(1, self.get_input_dims()):
                ind = np.logical_and(ind, np.logical_and(self.X[:, i] >= start[i], self.X[:, i] < end[i]))

        self.X = self.X[ind, :]
        self.Y = self.Y[ind]
        if self.Y_err is not None:
            self.Y_err = self.Y_err[ind]
        self.mask = self.mask[ind]

    def aggregate(self, duration, f=np.mean, f_err=None):
        """Bin data by duration and reduce with f (reference: mogptk/data.py:503-541)."""
        if 1 < self.get_input_dims():
            raise ValueError("aggregate works only with a single input dimension")

        start = np.min(self.X[:, 0])
        end = np.max(self.X[:, 0])
        step = _parse_delta(duration, self.X_dtypes[0])
        if f_err is None:
            f_err = f

        X = np.arange(start + step / 2, end + step / 2, step).reshape(-1, 1)
        Y = np.empty((X.shape[0],))
        keep = np.ones(X.shape[0], dtype=bool)
        if self.Y_err is not None:
            Y_err = np.empty((X.shape[0],))
        for i in range(X.shape[0]):
            ind = (self.X[:, 0] >= X[i, 0] - step / 2) & (self.X[:, 0] < X[i, 0] + step / 2)
            if not np.any(ind):
                # empty bin (sensor gap): drop it instead of producing NaN
                keep[i] = False
                Y[i] = 0.0
                if self.Y_err is not None:
                    Y_err[i] = 0.0
                continue
            Y[i] = f(self.Y[ind])
            if self.Y_err is not None:
                Y_err[i] = f_err(self.Y_err[ind])
        self.X = X[keep]
        self.Y = Y[keep]
        if self.Y_err is not None:
            self.Y_err = Y_err[keep]
        self.mask = np.ones(len(self.Y), dtype=bool)

    # -- accessors -------------------------------------------------------------
    def get_name(self):
        return self.name

    def has_test_data(self):
        """True if observations have been removed (reference: mogptk/data.py:558-569)."""
        return bool(np.any(~self.mask))

    def get_input_dims(self):
        return self.X.shape[1]

    def get_data(self, transformed=False):
        """All observations (train + test) (reference: mogptk/data.py:584-600)."""
        if transformed:
            return self.X, self.Y_transformer.forward(self.Y, self.X)
        return self.X, self.Y

    def get_train_data(self, transformed=False):
        """Observations used for training (reference: mogptk/data.py:602-619)."""
        if transformed:
            return self.X[self.mask, :], self.Y_transformer.forward(self.Y[self.mask], self.X[self.mask, :])
        return self.X[self.mask, :], self.Y[self.mask]

    def get_test_data(self, transformed=False):
        """Removed observations used for testing (reference: mogptk/data.py:621-645)."""
        X = self.X[~self.mask, :]
        if self.F is not None:
            if X.shape[0] == 0:
                X, _ = self.get_data()
            # F's contract is the per-dimension DATA dtype (datetime64 axes
            # probe F with datetime64 in _check_function)
            Y = np.asarray(self.F(*[X[:, i].astype(self.X_dtypes[i])
                                    for i in range(X.shape[1])])).reshape(-1)
            if transformed:
                Y = self.Y_transformer.forward(Y, X)
            return X, Y
        if transformed:
            return X, self.Y_transformer.forward(self.Y[~self.mask], X)
        return X, self.Y[~self.mask]

    # -- removal (test-set construction / sensor-failure simulation) --------
    def reset(self):
        """Undo all removals and the prediction range (reference: mogptk/data.py:649-656)."""
        self.mask[:] = True
        for i in range(len(self.removed_ranges)):
            self.removed_ranges[i] = []
        self.X_pred = None

    def remove(self, n=None, pct=None):
        """Deterministic equidistant subsample removal (reference: mogptk/data.py:658-681)."""
        if n is None:
            n = 0 if pct is None else int(pct * len(self.Y))
        elif not isinstance(n, (int, np.integer)):
            raise ValueError("n must be an integer")
        idx = (np.linspace(0, len(self.Y) - 1, n) + 0.1).astype(np.int64)
        self.mask[idx] = False

    def remove_randomly(self, n=None, pct=None):
        """Random removal (reference: mogptk/data.py:683-705)."""
        if n is None:
            n = 0 if pct is None else int(pct * len(self.Y))
        elif not isinstance(n, (int, np.integer)):
            raise ValueError("n must be an integer")
        # the package-seeded RNG (gpr.set_seed), not global np.random: test
        # splits stay reproducible alongside LoadFunction's draws
        from .gpr.config import config as _cfg
        idx = _cfg.numpy_rng().permutation(len(self.Y))[:n]
        self.mask[idx] = False

    def _add_range(self, start, end, dim):
        """Insert a removed range keeping ranges sorted and merged
        (reference: mogptk/data.py:707-729)."""
        ranges = self.removed_ranges[dim]
        idx = 0
        while idx < len(ranges) and ranges[idx][0] < start:
            idx += 1
        if 0 < idx and start <= ranges[idx - 1][1]:
            start = ranges[idx - 1][0]
            idx -= 1
        rem = 0
        for i in range(idx, len(ranges)):
            if end < ranges[i][0]:
                break
            end = max(end, ranges[i][1])
            rem += 1
        self.removed_ranges[dim] = ranges[:idx] + [(start, end)] + ranges[idx + rem:]

    def remove_range(self, start=None, end=None, dim=None):
        """Remove observations in [start, end] (reference: mogptk/data.py:731-770)."""
        if start is None:
            if dim is None:
                start = [np.min(self.X[:, i]) for i in range(self.get_input_dims())]
            else:
                start = [np.min(self.X[:, i]) if i == dim else None for i in range(self.get_input_dims())]
        if end is None:
            if dim is None:
                end = [np.max(self.X[:, i]) for i in range(self.get_input_dims())]
            else:
                end = [np.max(self.X[:, i]) if i == dim else None for i in range(self.get_input_dims())]

        start = self._normalize_x_val(start, dim=dim)
        end = self._normalize_x_val(end, dim=dim)

        if dim is not None:
            mask = np.logical_and(self.X[:, dim] >= start[dim], self.X[:, dim] <= end[dim])
            self._add_range(start[dim], end[dim], dim)
        else:
            mask = np.logical_and(self.X[:, 0] >= start[0], self.X[:, 0] <= end[0])
            for i in range(1, self.get_input_dims()):
                mask = np.logical_or(mask, np.logical_and(self.X[:, i] >= start[i], self.X[:, i] <= end[i]))
            for i in range(self.get_input_dims()):
                self._add_range(start[i], end[i], i)
        self.mask[mask] = False

    def remove_relative_range(self, start=0.0, end=1.0, dim=None):
        """Remove a relative fraction of the X range (reference: mogptk/data.py:772-789)."""
        start = self._normalize_val(start)
        end = self._normalize_val(end)
        xmin = [np.min(self.X[:, i]) for i in range(self.get_input_dims())]
        xmax = [np.max(self.X[:, i]) for i in range(self.get_input_dims())]
        for i in range(self.get_input_dims()):
            start[i] = xmin[i] + max(0.0, min(1.0, float(start[i]))) * (xmax[i] - xmin[i])
            end[i] = xmin[i] + max(0.0, min(1.0, float(end[i]))) * (xmax[i] - xmin[i])
        self.remove_range(start, end, dim)

    def remove_random_ranges(self, n, duration, dim=0):
        """Remove n random ranges of the given width to simulate sensor
        failure (reference: mogptk/data.py:791-820)."""
        if n < 1:
            return
        delta = _parse_delta(duration, self.X_dtypes[dim])
        m = (np.max(self.X[:, dim]) - np.min(self.X[:, dim])) - n * delta
        if m <= 0:
            raise ValueError("no data left after removing ranges")

        locs = self.X[:, dim] <= (np.max(self.X[:, dim]) - delta)
        if int(np.sum(locs)) < len(locs):
            locs[int(np.sum(locs))] = True  # allow the last data point to be deleted
        from .gpr.config import config as _cfg
        rng = _cfg.numpy_rng()
        for i in range(n):
            avail = self.X[locs, dim]
            if avail.shape[0] == 0:
                break
            x = avail[rng.integers(avail.shape[0])]
            locs[(self.X[:, dim] > x - delta) & (self.X[:, dim] < x + delta)] = False
            self.remove_range(x, x + delta, dim)

    def remove_indices(self, indices):
        """Remove observations at indices (reference: mogptk/data.py:822-833)."""
        if isinstance(indices, list):
            indices = np.array(indices)
        elif not isinstance(indices, np.ndarray):
            raise ValueError("indices must be list or numpy array")
        self.mask[indices] = False

    # -- prediction range -----------------------------------------------------
    def get_prediction_data(self):
        """X points used for prediction (reference: mogptk/data.py:837-849)."""
        if self.X_pred is None:
            return self.X
        return self.X_pred

    def set_prediction_data(self, X):
        """Set explicit prediction points (reference: mogptk/data.py:851-864)."""
        X_pred, _ = self._format_X(X)
        if X_pred.shape[1] != self.X.shape[1]:
            raise ValueError("X must have the same number of input dimensions as the data")
        self.X_pred = X_pred

    def set_prediction_range(self, start=None, end=None, n=None, step=None):
        """Set the prediction interval [start, end] with n points or a step
        (reference: mogptk/data.py:866-920)."""
        if start is None:
            start = [np.min(self.X[:, i]) for i in range(self.get_input_dims())]
        if end is None:
            end = [np.max(self.X[:, i]) for i in range(self.get_input_dims())]

        start = self._normalize_x_val(start)
        end = self._normalize_x_val(end)
        n = self._normalize_val(n)
        step = self._normalize_val(step)
        for i in range(self.get_input_dims()):
            if n is not None and not isinstance(n[i], (int, np.integer)):
                raise ValueError("n must be integer")

        if np.any(np.asarray(end) <= np.asarray(start)):
            raise ValueError("start must be lower than end")

        X_pred = [np.array([])] * self.get_input_dims()
        for i in range(self.get_input_dims()):
            if n is not None and n[i] is not None:
                X_pred[i] = start[i] + (end[i] - start[i]) * np.linspace(0.0, 1.0, n[i])
            else:
                if step is None or step[i] is None:
                    x_step = (end[i] - start[i]) / 100
                else:
                    x_step = _parse_delta(step[i], self.X_dtypes[i])
                X_pred[i] = np.arange(start[i], end[i] + x_step, x_step)

        counts = [X_pred[i].shape[0] for i in range(self.get_input_dims())]
        for i in range(self.get_input_dims()):
            n_tile = int(np.prod(counts[:i])) if i > 0 else 1
            n_repeat = int(np.prod(counts[i + 1:])) if i < len(counts) - 1 else 1
            X_pred[i] = np.tile(np.repeat(X_pred[i], n_repeat), n_tile)
        self.X_pred = np.array(X_pred).T

    # -- spectral estimation -----------------------------------------------------
    def get_nyquist_estimation(self):
        """Nyquist frequency = 0.5/min point spacing per input dimension
        (reference: mogptk/data.py:924-944)."""
        input_dims = self.get_input_dims()
        nyquist = np.empty((input_dims,))
        for i in range(input_dims):
            x = np.sort(self.X[self.mask, i])
            dist = np.abs(x[1:] - x[:-1])
            if len(dist) == 0:
                nyquist[i] = 0.0
            else:
                dist = np.min(dist[np.nonzero(dist)])
                nyquist[i] = 0.5 / dist
        return nyquist

    def _get_psd_peaks(self, w, psd):
        """Extract Gaussian (amplitude, position, variance) from PSD peaks via
        FWHM widths (reference: mogptk/data.py:946-961)."""
        from scipy import signal
        peaks, _ = signal.find_peaks(psd)
        if len(peaks) == 0:
            return np.array([]), np.array([]), np.array([])
        peaks = peaks[np.argsort(psd[peaks])[::-1]]
        peaks = peaks[0.0 < psd[peaks]]

        widths, _, _, _ = signal.peak_widths(psd, peaks, rel_height=0.5)
        widths = widths * (w[1] - w[0])

        positions = w[peaks]
        variances = widths ** 2 / (8.0 * np.log(2.0))  # FWHM → Gaussian σ²
        amplitudes = np.sqrt(psd[peaks])
        return amplitudes, positions, variances

    def get_ls_estimation(self, Q=1, n=10000):
        """Spectral peak estimation via Lomb-Scargle
        (reference: mogptk/data.py:963-1002)."""
        from scipy import signal
        input_dims = self.get_input_dims()
        A = np.zeros((Q, input_dims))
        B = np.zeros((Q, input_dims))
        C = np.zeros((Q, input_dims))

        nyquist = self.get_nyquist_estimation()
        x, y = self.get_train_data(transformed=True)
        for i in range(input_dims):
            w = np.linspace(0.0, nyquist[i], n)[1:]
            psd = signal.lombscargle(x[:, i] * 2.0 * np.pi, y, w)
            psd /= x.shape[0] / 4.0
            amplitudes, positions, variances = self._get_psd_peaks(w, psd)
            if len(positions) == 0:
                continue
            if Q < len(amplitudes):
                amplitudes = amplitudes[:Q]
                positions = positions[:Q]
                variances = variances[:Q]
            num = len(amplitudes)
            A[:num, i] = amplitudes
            B[:num, i] = positions
            C[:num, i] = variances
        return A, B, C

    def get_bnse_estimation(self, Q=1, n=1000, iters=200):
        """Spectral peak estimation via BNSE (reference: mogptk/data.py:1004-1051)."""
        from .init import BNSE
        input_dims = self.get_input_dims()
        A = np.zeros((Q, input_dims))
        B = np.zeros((Q, input_dims))
        C = np.zeros((Q, input_dims))

        nyquist = self.get_nyquist_estimation()
        x, y = self.get_train_data(transformed=True)
        y_err = None
        if self.Y_err is not None:
            y_err_lower = self.Y_transformer.forward(self.Y[self.mask] - self.Y_err[self.mask], x)
            y_err_upper = self.Y_transformer.forward(self.Y[self.mask] + self.Y_err[self.mask], x)
            y_err = (y_err_upper - y_err_lower) / 2.0
        for i in range(input_dims):
            w, psd, _ = BNSE(x[:, i], y, y_err=y_err, max_freq=nyquist[i], n=n, iters=iters)
            psd = np.array(psd)
            # empirical PSD normalization carried over from the reference
            # (mogptk/data.py:1035-1037)
            psd /= (np.max(x[:, i]) - np.min(x[:, i])) ** 2
            psd *= np.pi
            amplitudes, positions, variances = self._get_psd_peaks(w, psd)
            if len(positions) == 0:
                continue
            if Q < len(amplitudes):
                amplitudes = amplitudes[:Q]
                positions = positions[:Q]
                variances = variances[:Q]
            num = len(amplitudes)
            A[:num, i] = amplitudes
            B[:num, i] = positions
            C[:num, i] = variances
        return A, B, C

    def get_sm_estimation(self, Q=1, method="LS", optimizer="Adam", iters=200, params=None):
        """Spectral peak estimation by pre-fitting an SM model
        (reference: mogptk/data.py:1053-1087). Not ported yet: the SM model
        and its kernels are ROADMAP queue 1, item 9."""
        raise NotImplementedError("the SM-model spectral estimate needs the SM model, which is "
                                  "not ported yet (ROADMAP queue 1, item 9)")

    # -- plotting -----------------------------------------------------------------
    # Data preparation lives here; rendering goes through mogptk_tpu_torch.plotting
    # (covers reference mogptk/data.py:1089-1279).

    def _require_plottable(self):
        if self.get_input_dims() > 2:
            raise ValueError("cannot plot more than two input dimensions")
        if self.get_input_dims() == 2:
            raise NotImplementedError("two dimensional input data not yet implemented")

    def _axis_dtype(self):
        """dtype the x-axis should be rendered in (None = plain numeric)."""
        return self.X_dtypes[0] if _is_datetime64(self.X_dtypes[0]) else None

    def _x_range(self):
        """Observation + prediction-range x extent, as float64."""
        lo, hi = np.min(self.X), np.max(self.X)
        if self.X_pred is not None:
            lo = min(lo, np.min(self.X_pred))
            hi = max(hi, np.max(self.X_pred))
        return float(lo), float(hi)

    def _latent_curve(self, xmin, xmax, transformed=False):
        """Evaluate the known latent F densely over [xmin, xmax]; returns
        (x_float64, y) or None. F's contract is the DATA dtype — datetime64
        axes probe F with datetime64 in _check_function, so those axes get a
        one-unit-step datetime grid, not a float grid."""
        if self.F is None:
            return None
        x = np.linspace(xmin, xmax, 10 * len(self.X))
        if _is_datetime64(self.X_dtypes[0]):
            # snap samples to whole axis units and dedupe (a fine-unit axis
            # must NOT get a one-unit-step grid: us units over months is TiB)
            grid = np.unique(x.astype(self.X_dtypes[0]))
            x = grid.astype(np.float64)
        else:
            grid = x
        y = self.F(grid)
        if transformed:
            y = self.Y_transformer.forward(y, x.reshape(-1, 1))
        return x, y

    def _errorbar_data(self, transformed=False):
        """(x, y, lo, hi) whiskers for observations carrying Y_err, or None."""
        if self.Y_err is None:
            return None
        x, y = self.get_train_data(transformed=transformed)
        lo = self.Y[self.mask] - self.Y_err[self.mask]
        hi = self.Y[self.mask] + self.Y_err[self.mask]
        if transformed:
            lo = self.Y_transformer.forward(lo, x)
            hi = self.Y_transformer.forward(hi, x)
        return x[:, 0], y, lo, hi

    def _push_observations(self, canvas, transformed=False, errorbars=True):
        """Layer this channel's observations onto a plotting.Canvas: error
        whiskers, latent truth, test/train points, removed-range shading.
        Shared by Data.plot and Model.plot_prediction. Returns the x extent."""
        xmin, xmax = self._x_range()
        if errorbars:
            eb = self._errorbar_data(transformed)
            if eb is not None:
                canvas.errorbars(*eb)
        latent = self._latent_curve(xmin, xmax, transformed)
        if latent is not None:
            canvas.curve(latent[0], latent[1], "latent", "Latent")
        if self.has_test_data():
            x, y = self.get_test_data(transformed=transformed)
            canvas.points(x[:, 0], y, "test", "Test data")
        x, y = self.get_train_data(transformed=transformed)
        canvas.points(x[:, 0], y, "train", "Train data")
        canvas.spans(self.removed_ranges[0], "removed", "Removed ranges")
        return xmin, xmax

    def plot(self, pred=None, title=None, ax=None, legend=True, errorbars=True, transformed=False):
        """Plot observations, removed ranges, and the latent function."""
        from . import plotting
        self._require_plottable()
        if ax is None:
            _, axes = plotting.grid(1, 1)
            ax = axes[0, 0]
        canvas = plotting.Canvas(ax, x_dtype=self._axis_dtype())
        xmin, xmax = self._push_observations(canvas, transformed=transformed,
                                             errorbars=errorbars)
        canvas.finish(xlim=(xmin, xmax), xlabel=self.X_labels[0],
                      ylabel=self.Y_label,
                      title=self.name if title is None else title,
                      legend=legend)
        return ax

    def periodogram(self, method="ls", per=None, maxfreq=None, n=10000,
                    transformed=True):
        """Spectral density estimate of this channel's observations.

        Returns ``(freqs, psd, psd_err, unit)``: a density normalized to
        integrate to 1 on its grid, an error band (empty unless
        method='bnse'), and the frequency unit name for axis labeling
        (datetime64 axes default to their native unit; ``per`` overrides).
        With ``maxfreq=None`` the grid runs to the Nyquist rate of the mean
        sampling interval and is trimmed to the 99% cumulative-mass point.
        """
        from scipy import signal
        from . import plotting
        self._require_plottable()

        x_scale, unit = 1.0, per
        if _is_datetime64(self.X_dtypes[0]):
            if per is None:
                unit = _datetime64_unit_names[_get_time_unit(self.X_dtypes[0])]
            else:
                x_scale = 1.0 / _parse_delta(per, self.X_dtypes[0])
                unit = "%s" % (per,)

        Y = self.Y_transformer.forward(self.Y, self.X) if transformed else self.Y
        order = np.argsort(self.X[:, 0])
        x = self.X[order, 0] * x_scale
        y = Y[order]

        nyquist = maxfreq if maxfreq is not None else \
            float(0.5 / np.average(np.abs(np.diff(x))))

        err = np.array([])
        if method.lower() == "ls":
            freqs = np.linspace(0.0, nyquist, n + 1)[1:]
            psd = signal.lombscargle(2.0 * np.pi * x, y, freqs)
        elif method.lower() == "bnse":
            from .init import BNSE
            freqs, psd, err = BNSE(x, y, max_freq=nyquist, n=n)
        else:
            raise ValueError('periodogram method "%s" does not exist' % (method,))

        psd = plotting.normalize_density(psd, freqs)
        if maxfreq is None:
            keep = np.cumsum(psd) * (freqs[1] - freqs[0]) < 0.99
            freqs, psd = freqs[keep], psd[keep]
            if err.size:
                err = err[keep]
        return freqs, psd, err, unit

    def plot_spectrum(self, title=None, method="ls", ax=None, per=None, maxfreq=None,
                      log=False, transformed=True, n=10000):
        """Plot the Lomb-Scargle / BNSE spectrum of the observations."""
        from . import plotting
        freqs, psd, err, unit = self.periodogram(
            method=method, per=per, maxfreq=maxfreq, n=n, transformed=transformed)

        ax_given = ax is not None
        if ax is None:
            _, axes = plotting.grid(1, 1)
            ax = axes[0, 0]
        canvas = plotting.Canvas(ax)
        canvas.curve(freqs, psd, "psd")
        if err.size:
            band = 2.0 * np.sqrt(err)
            canvas.band(freqs, psd - band, psd + band, "psd-err")
        if title is None:
            title = self.name + " Spectrum" if self.name is not None else ""
        canvas.finish(
            xlim=None if ax_given else (freqs.min(), freqs.max()), xpad=0.005,
            xlabel="Frequency" + (" [1/%s]" % unit if unit is not None else ""),
            title=title, legend=False, logx=log, logy=log, hide_yticks=True)
        if not log:
            ax.set_ylim(0, None)
        return ax

    # -- value normalization ------------------------------------------------------
    def _normalize_val(self, val):
        """Expand a scalar to a per-input-dimension list (reference: mogptk/data.py:1281-1296)."""
        if val is None:
            return val
        if isinstance(val, np.ndarray):
            val = [val.item()] if val.ndim == 0 else list(val)
        elif _is_iterable(val):
            val = list(val)
        else:
            val = [val] * self.get_input_dims()
        if len(val) != self.get_input_dims():
            raise ValueError("value must be a scalar or a list of values for each input dimension")
        return val

    def _normalize_x_val(self, val, dim=None):
        """Normalize X-axis values to float64 through the per-dim dtype
        (reference: mogptk/data.py:1298-1313)."""
        val = self._normalize_val(val)
        dims = [dim] if dim is not None else range(self.get_input_dims())
        for i in dims:
            try:
                val[i] = np.array(val[i]).astype(self.X_dtypes[i]).astype(np.float64)
            except Exception:
                raise ValueError("value must be of type %s" % (self.X_dtypes[i],))
        return val


# -- module helpers (reference: mogptk/data.py:1315-1445) --------------------

def _is_tensor(x):
    mod = type(x).__module__ or ""
    return mod.startswith("torch")


def _to_numpy(x):
    import pandas as pd
    if isinstance(x, pd.Series):
        return x.to_numpy()
    if _is_tensor(x):
        # np.asarray fails on a CUDA tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _is_iterable(val):
    return isinstance(val, collections.abc.Iterable) and not isinstance(val, (dict, str))


def _is_homogeneous_type(seq):
    it = iter(seq)
    first = type(next(it))
    return all(type(x) is first for x in it)


def _check_function(f, input_dims, is_datetime64):
    if not callable(f):
        raise ValueError("must pass a function with %d parameters" % (input_dims,))
    sig = inspect.signature(f)
    if len(sig.parameters) != input_dims:
        raise ValueError("must pass a function with %d parameters" % (input_dims,))

    x = [np.array([np.datetime64("2000", "us")]) if is_datetime64[i] else np.ones((1,)) for i in range(input_dims)]
    y = f(*x)
    if y.ndim != 1 or y.shape[0] != 1:
        raise ValueError("function must return Y with shape (data_points,), note that all inputs are of shape (data_points,)")


_datetime64_unit_names = {
    "Y": "year", "M": "month", "W": "week", "D": "day",
    "h": "hour", "m": "minute", "s": "second",
    "ms": "millisecond", "us": "microsecond",
}

duration_regex = re.compile(
    r"^((?P<years>[\.\d]+?)Y)?"
    r"((?P<months>[\.\d]+?)M)?"
    r"((?P<weeks>[\.\d]+?)W)?"
    r"((?P<days>[\.\d]+?)D)?"
    r"((?P<hours>[\.\d]+?)h)?"
    r"((?P<minutes>[\.\d]+?)m)?"
    r"((?P<seconds>[\.\d]+?)s)?"
    r"((?P<milliseconds>[\.\d]+?)ms)?"
    r"((?P<microseconds>[\.\d]+?)us)?$"
)


def _parse_delta(text, dtype):
    """Parse '3W1D'-style duration strings or unit names into a float step in
    the dtype's unit (reference: mogptk/data.py:1361-1413)."""
    if np.issubdtype(dtype, np.datetime64):
        dtype = "timedelta64[%s]" % (_get_time_unit(dtype) or "us",)

    unit_names = {
        "year": "Y", "month": "M", "week": "W", "day": "D",
        "hour": "h", "minute": "m", "second": "s",
        "millisecond": "ms", "microsecond": "us",
    }
    val = None
    if not isinstance(text, str):
        val = np.array(text)
    else:
        word = text[:-1] if text.endswith("s") and text[:-1] in unit_names else text
        if word in unit_names:
            val = np.timedelta64(1, unit_names[word])
    if val is not None:
        if val.dtype.kind == "m":
            return val.astype(dtype).astype(np.float64)
        return val.astype(np.float64)

    m = duration_regex.match(text)
    if m is None or all(v is None for v in m.groupdict().values()):
        raise ValueError(
            "duration string must be of the form 2h45m, allowed characters: "
            "(Y)ear, (M)onth, (W)eek, (D)ay, (h)our, (m)inute, (s)econd, "
            "(ms) for milliseconds, (us) for microseconds")

    units = [("years", "Y"), ("months", "M"), ("weeks", "W"), ("days", "D"),
             ("hours", "h"), ("minutes", "m"), ("seconds", "s"),
             ("milliseconds", "ms"), ("microseconds", "us")]
    matches = m.groupdict()
    delta = None
    for key, unit in units:
        if matches[key]:
            d = np.timedelta64(np.int32(matches[key]), unit)
            delta = d if delta is None else delta + d
    return delta.astype(dtype).astype(np.float64)


def _datetime64_to_higher_unit(array):
    """Promote datetime64[us] to the highest linear unit that loses no
    information (reference: mogptk/data.py:1415-1424)."""
    if array.dtype in ["<M8[Y]", "<M8[M]", "<M8[W]", "<M8[D]"]:
        return array
    units = ["D", "h", "m", "s"]  # months/years are non-linear
    for unit in units:
        frac, _ = np.modf((array - np.datetime64("2000")) / np.timedelta64(1, unit))
        if not np.any(frac):
            return array.astype("datetime64[%s]" % (unit,))
    return array


def _timedelta64_to_higher_unit(array):
    """Same promotion for timedelta64 (reference: mogptk/data.py:1426-1435)."""
    if array.dtype in ["<m8[Y]", "<m8[M]", "<m8[W]", "<m8[D]"]:
        return array
    units = ["D", "h", "m", "s"]
    for unit in units:
        frac, _ = np.modf(array / np.timedelta64(1, unit))
        if not np.any(frac):
            return array.astype("timedelta64[%s]" % (unit,))
    return array


def _is_datetime64(dtype):
    return np.issubdtype(dtype, np.datetime64)


def _get_time_unit(dtype):
    unit = str(dtype)
    locBracket = unit.find("[")
    if locBracket == -1:
        return ""
    return unit[locBracket + 1:-1]
