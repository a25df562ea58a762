"""Multi-channel dataset: an ordered list of Data channels with broadcast
operations and CSV/DataFrame loaders.

Capability parity with mogptk/dataset.py (LoadCSV 10-33, LoadDataFrame
35-124, DataSet 130-740). A copy of mogptk_tpu/dataset.py, kept in this
package so that it imports nothing of the JAX package. The SM-model spectral
estimate raises until the SM model is ported.
"""
import copy
import numpy as np

from .data import Data, _is_iterable, _is_tensor, _to_numpy


def LoadCSV(filename, x_col=0, y_col=1, y_err_col=None, name=None, **kwargs):
    """Load channels from a CSV file (reference: mogptk/dataset.py:10-33)."""
    import pandas as pd
    df = pd.read_csv(filename, **kwargs)
    return LoadDataFrame(df, x_col, y_col, y_err_col, name)


def LoadDataFrame(df, x_col=0, y_col=1, y_err_col=None, name=None):
    """Load channels from a pandas DataFrame; one channel per y column,
    rows with NaNs dropped per channel (reference: mogptk/dataset.py:35-124).

    Note: the reference overwrote y_col when y_err_col was iterable
    (dataset.py:70, a known defect); here the intended assignment is used.
    """
    def _check_cols(col, what):
        if _is_iterable(col):
            col = list(col)
        if ((not isinstance(col, list)
             or not all(isinstance(item, int) for item in col)
             and not all(isinstance(item, str) for item in col))
                and not isinstance(col, (int, str))):
            raise ValueError("%s must be integer, string or list of integers or strings" % what)
        if not isinstance(col, list):
            col = [col]
        return col

    x_col = _check_cols(x_col, "x_col")
    y_col = _check_cols(y_col, "y_col")
    if y_err_col is not None:
        y_err_col = _check_cols(y_err_col, "y_err_col")
        if len(y_col) != len(y_err_col):
            raise ValueError("y_err_col and y_col must be of the same length")

    if name is None:
        name = [None] * len(y_col)
    else:
        name = list(name) if _is_iterable(name) else [name]
        if len(y_col) != len(name):
            raise ValueError("y_col and name must be of the same length")

    if all(isinstance(item, int) for item in x_col):
        x_col = [df.columns[item] for item in x_col]
    if all(isinstance(item, int) for item in y_col):
        y_col = [df.columns[item] for item in y_col]
    if y_err_col is not None and all(isinstance(item, int) for item in y_err_col):
        y_err_col = [df.columns[item] for item in y_err_col]

    cols = x_col + y_col
    if y_err_col is not None:
        cols = cols + y_err_col
    df = df[cols].copy()
    # numeric columns may carry string missing-value markers (e.g. "."):
    # coerce to NaN so the per-channel dropna removes them
    import pandas as pd
    for col in y_col + (y_err_col or []):
        df[col] = pd.to_numeric(df[col], errors="coerce")
    if len(df.index) == 0:
        raise ValueError("dataframe cannot be empty")

    dataset = DataSet()
    for i in range(len(y_col)):
        cols = x_col + [y_col[i]]
        if y_err_col is not None:
            cols = cols + [y_err_col[i]]
        channel = df[cols].dropna()

        y_err = None
        if y_err_col is not None:
            y_err = channel[y_err_col[i]].to_numpy()

        dataset.append(Data(
            # to_numpy(): pandas 3.0 .values may return Arrow-backed arrays
            [channel[col].to_numpy() for col in x_col],
            channel[y_col[i]].to_numpy(),
            Y_err=y_err,
            name=name[i],
            # headerless CSVs yield integer column labels; coerce to str
            x_labels=[str(col) for col in x_col],
            y_label=str(y_col[i]),
        ))
    if dataset.get_output_dims() == 1:
        return dataset[0]
    return dataset


class DataSet:
    """Ordered list of Data channels — the complete multi-output GP data
    representation (reference: mogptk/dataset.py:130-740)."""

    def __init__(self, *args, names=None):
        import pandas as pd
        self.channels = []

        def _is_arraylike(a):
            return isinstance(a, (np.ndarray, pd.Series)) or _is_tensor(a)

        if (len(args) == 2
                and (_is_arraylike(args[0]) or isinstance(args[0], list) and all(_is_arraylike(i) for i in args[0]))
                and (_is_arraylike(args[1]) or isinstance(args[1], list) and all(_is_arraylike(i) for i in args[1]))):
            args = list(args)
            if _is_arraylike(args[0]) and _to_numpy(args[0]).ndim == 3:
                args[0] = [channel for channel in _to_numpy(args[0])]
            if _is_arraylike(args[1]) and _to_numpy(args[1]).ndim == 2:
                args[1] = [channel for channel in _to_numpy(args[1])]

            n = 1
            if isinstance(args[0], list):
                n = max(n, len(args[0]))
            if isinstance(args[1], list):
                n = max(n, len(args[1]))
            if names is None or isinstance(names, str):
                names = [names] * n
            elif len(names) != n:
                # zip() would silently DROP channels beyond len(names)
                raise ValueError("names must have one entry per channel "
                                 "(%d given, %d channels)" % (len(names), n))

            if isinstance(args[0], list):
                if isinstance(args[1], list):
                    if len(args[0]) != len(args[1]):
                        raise ValueError("X and y must have the same number of output dimensions")
                    for nm, x, y in zip(names, args[0], args[1]):
                        self.append(Data(x, y, name=nm))
                else:
                    for nm, x in zip(names, args[0]):
                        self.append(Data(x, args[1], name=nm))
            else:
                if isinstance(args[1], list):
                    for nm, y in zip(names, args[1]):
                        self.append(Data(args[0], y, name=nm))
                else:
                    self.append(Data(args[0], args[1], name=names[0]))
            return

        for arg in args:
            self.append(arg)

    def _format_X(self, X):
        """Coerce prediction input (dict/array/list) to a per-channel list of
        float X arrays (reference: mogptk/dataset.py:199-223)."""
        import pandas as pd
        if isinstance(X, dict):
            x_dict = X
            X = self.get_prediction_data()
            for name, channel_x in x_dict.items():
                X[self.get_index(name)] = channel_x
        elif isinstance(X, (np.ndarray, pd.Series)) or _is_tensor(X):
            X = _to_numpy(X)
            if X.ndim == 3 and X.shape[0] == self.get_output_dims():
                X = [X[i, :, :] for i in range(self.get_output_dims())]
            else:
                X = [X] * self.get_output_dims()
        elif not isinstance(X, list):
            raise ValueError("X must be a list, dict, numpy.ndarray, pandas.Series, or tensor")
        elif not any(isinstance(x, (list, np.ndarray, pd.Series))
                     or _is_tensor(x) for x in X):
            # a list of SCALARS is one set of coordinates for every channel;
            # a list of arrays (numpy/pandas/torch) is per-channel
            X = [X] * self.get_output_dims()
        if len(X) != self.get_output_dims():
            raise ValueError("X must be of shape (data_points,), (data_points,input_dims), or [(data_points,)] * input_dims for each channel")

        X = list(X)
        for j, channel in enumerate(self.channels):
            X[j], _ = channel._format_X(X[j])
        return X

    def __iter__(self):
        return self.channels.__iter__()

    def __len__(self):
        return len(self.channels)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.channels[self.get_names().index(key)]
        return self.channels[key]

    def __setitem__(self, key, arg):
        if isinstance(arg, Data):
            self.channels[key] = arg
        elif isinstance(arg, DataSet) and len(arg) == 1:
            self.channels[key] = arg[0]
        else:
            raise ValueError("must set a data type of Data or a DataSet with a single channel")

    def __str__(self):
        return self.__repr__()

    def __repr__(self):
        return "".join(channel.__repr__() + "\n" for channel in self.channels)

    def append(self, arg):
        """Append channel(s): Data, DataSet, list, or dict (keys become names)
        (reference: mogptk/dataset.py:253-277)."""
        if isinstance(arg, Data):
            self.channels.append(arg)
        elif isinstance(arg, DataSet):
            for val in arg.channels:
                self.channels.append(val)
        elif isinstance(arg, list) and all(isinstance(val, Data) for val in arg):
            for val in arg:
                self.channels.append(val)
        elif isinstance(arg, dict) and all(isinstance(val, Data) for val in arg.values()):
            for key, val in arg.items():
                val.name = key
                self.channels.append(val)
        else:
            raise ValueError("unknown data type %s in append to DataSet" % (type(arg),))
        return self

    def copy(self):
        return copy.deepcopy(self)

    # -- broadcast ops -----------------------------------------------------------
    def transform(self, transformer):
        for channel in self.channels:
            channel.transform(transformer)

    def filter(self, start, end, dim=None):
        for channel in self.channels:
            channel.filter(start, end, dim=dim)

    def aggregate(self, duration, f=np.mean):
        for channel in self.channels:
            channel.aggregate(duration, f)

    def has_test_data(self):
        return [channel.has_test_data() for channel in self.channels]

    # -- accessors -----------------------------------------------------------------
    def get_input_dims(self):
        return [channel.get_input_dims() for channel in self.channels]

    def get_output_dims(self):
        return len(self.channels)

    def get_names(self):
        return [channel.get_name() for channel in self.channels]

    def get(self, index):
        """Channel by index or name (reference: mogptk/dataset.py:395-415)."""
        if isinstance(index, int):
            if index < len(self.channels):
                return self.channels[index]
        elif isinstance(index, str):
            for channel in self.channels:
                if channel.name == index:
                    return channel
        raise ValueError("channel '%s' does not exist in DataSet" % (index,))

    def get_index(self, index):
        """Numeric index from index or name (reference: mogptk/dataset.py:417-437)."""
        if isinstance(index, int):
            if index < len(self.channels):
                return index
        elif isinstance(index, str):
            for i, channel in enumerate(self.channels):
                if channel.name == index:
                    return i
        raise ValueError("channel '%s' does not exist in DataSet" % (index,))

    # one getter call per channel (each call runs the Y transform, and for
    # function-backed channels evaluates F): X/Y come from the SAME call
    def get_data(self, transformed=False):
        out = [channel.get_data(transformed=transformed) for channel in self.channels]
        return [x for x, _ in out], [y for _, y in out]

    def get_train_data(self, transformed=False):
        out = [channel.get_train_data(transformed=transformed) for channel in self.channels]
        return [x for x, _ in out], [y for _, y in out]

    def get_test_data(self, transformed=False):
        out = [channel.get_test_data(transformed=transformed) for channel in self.channels]
        return [x for x, _ in out], [y for _, y in out]

    # -- prediction range ------------------------------------------------------------
    def get_prediction_data(self):
        return [channel.get_prediction_data() for channel in self.channels]

    def set_prediction_data(self, X):
        """Set per-channel prediction points (reference: mogptk/dataset.py:502-524)."""
        if isinstance(X, list):
            if len(X) != len(self.channels):
                raise ValueError("prediction x expected to be a list of shape (output_dims,n)")
            for i, channel in enumerate(self.channels):
                channel.set_prediction_data(X[i])
        elif isinstance(X, dict):
            for name in X:
                self.get(name).set_prediction_data(X[name])
        else:
            for channel in self.channels:
                channel.set_prediction_data(X)

    def set_prediction_range(self, start, end, n=None, step=None):
        """Set per-channel prediction intervals (reference: mogptk/dataset.py:526-565)."""
        def _expand(v, default=None):
            if v is None:
                return [default] * self.get_output_dims()
            if isinstance(v, dict):
                return [v[name] for name in self.get_names()]
            if not isinstance(v, list):
                return [v] * self.get_output_dims()
            return v

        start = _expand(start)
        end = _expand(end)
        n = _expand(n)
        step = _expand(step)

        if (len(start) != len(self.channels) or len(end) != len(self.channels)
                or len(n) != len(self.channels) or len(step) != len(self.channels)):
            raise ValueError("start, end, n, and/or step must be lists of shape (output_dims,n)")

        for i, channel in enumerate(self.channels):
            channel.set_prediction_range(start[i], end[i], n[i], step[i])

    # -- estimation broadcasts --------------------------------------------------------
    def get_nyquist_estimation(self):
        return [channel.get_nyquist_estimation() for channel in self.channels]

    def get_ls_estimation(self, Q=1, n=10000):
        out = [channel.get_ls_estimation(Q, n) for channel in self.channels]
        return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]

    def get_bnse_estimation(self, Q=1, n=1000, iters=200):
        out = [channel.get_bnse_estimation(Q, n, iters=iters) for channel in self.channels]
        return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]

    def get_sm_estimation(self, Q=1, method="BNSE", optimizer="Adam", iters=200, params={}):
        out = [channel.get_sm_estimation(Q, method, optimizer, iters, params) for channel in self.channels]
        return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]

    # -- plotting ----------------------------------------------------------------------
    def plot(self, pred=None, title=None, figsize=None, legend=True, transformed=False):
        """Plot each channel stacked vertically (reference: mogptk/dataset.py:661-701)."""
        import matplotlib.pyplot as plt
        if figsize is None:
            figsize = (12, 4 * len(self.channels))

        h = figsize[1]
        fig, axes = plt.subplots(self.get_output_dims(), 1, figsize=figsize, squeeze=False, constrained_layout=True)

        legends = {}
        for channel in range(self.get_output_dims()):
            self.channels[channel].plot(ax=axes[channel, 0], transformed=transformed)
            l = axes[channel, 0].get_legend()
            if l is not None:
                handles = getattr(l, "legend_handles", None) or getattr(l, "legendHandles", [])
                for text, handle in zip(l.texts, handles):
                    legends[text.get_text()] = handle
                l.remove()

        legend_rows = (len(legends) - 1) / 5 + 1
        if title is not None:
            fig.suptitle(title, y=(h + 0.2 + 0.4 * legend_rows) / h, fontsize=18)

        if legend and legends:
            fig.legend(handles=list(legends.values()), ncol=5)
        return fig, axes

    def plot_spectrum(self, title=None, method="ls", per=None, maxfreq=None, figsize=None,
                      log=False, transformed=True, n=1001):
        """Plot each channel's spectrum (reference: mogptk/dataset.py:703-740)."""
        import matplotlib.pyplot as plt
        if not isinstance(method, list):
            method = [method] * len(self.channels)
        if not isinstance(per, list):
            per = [per] * len(self.channels)
        if not isinstance(maxfreq, list):
            maxfreq = [maxfreq] * len(self.channels)

        if figsize is None:
            figsize = (12, 4 * len(self.channels))

        fig, axes = plt.subplots(self.get_output_dims(), 1, figsize=figsize, squeeze=False, constrained_layout=True)
        if title is not None:
            fig.suptitle(title, fontsize=18)

        for channel in range(self.get_output_dims()):
            self.channels[channel].plot_spectrum(
                method=method[channel], ax=axes[channel, 0], per=per[channel],
                maxfreq=maxfreq[channel], log=log, transformed=transformed, n=n)
        return fig, axes
