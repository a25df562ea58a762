"""Declarative host-side plotting toolkit.

Every figure in the package is assembled through this module. The split is
deliberate: `model.py` / `data.py` / `util.py` only *prepare data* and push
semantic layers ("train points", "posterior mean", "confidence band",
"removed span") onto a :class:`Canvas`; the canvas owns every matplotlib
call — style lookup, legend proxy handles, datetime-axis casting, and the
shared axis cosmetics. Covers the same plot families as the reference
(mogptk/model.py:736-1037, mogptk/data.py:1089-1279, mogptk/util.py:130-234)
but is organized around this layer system rather than per-plot inline
matplotlib code. A copy of mogptk_tpu/plotting.py, kept in this package so
that it imports nothing of the JAX package; matplotlib is imported inside the
functions that draw.

Matplotlib is imported lazily so the package works headless without it.
"""
import numpy as np

# Semantic style registry: every layer a plot can contain, in one place.
# Colors/markers match the conventions users of the reference expect
# (black train dots, red test dots, dashed green latent, blue posterior).
STYLES = {
    "train":   dict(color="k", marker=".", markersize=10, linestyle=""),
    "test":    dict(color="r", marker=".", markersize=10, linestyle=""),
    "latent":  dict(color="g", linestyle="--", linewidth=1),
    "mean":    dict(color="blue", linestyle=":", linewidth=2),
    "band":    dict(color="blue", alpha=0.3, linewidth=0),
    "removed": dict(color="crimson", alpha=0.3, linewidth=0),
    "psd":     dict(color="k", linestyle="-", linewidth=2),
    "psd-err": dict(color="k", alpha=0.2, linewidth=0),
    "mixture": dict(color="b", linestyle="--", linewidth=1),
    "model":   dict(color="b", linestyle="-", linewidth=1.5),
    "peak":    dict(color="r", linewidth=3),
    "loss":    dict(color="k", linestyle="-"),
    "error":   dict(color="k", linestyle="-."),
    "kernel":  dict(color="k", linestyle="-"),
}


def _plt():
    import matplotlib.pyplot as plt
    return plt


def grid(rows=1, cols=1, width=12.0, row_height=4.0, title=None,
         figsize=None, sharex=False):
    """A rows×cols subplot grid with the package-wide figure defaults.

    Returns (fig, axes) with axes always 2-D (squeeze=False).
    """
    plt = _plt()
    if figsize is None:
        figsize = (width, row_height * rows)
    fig, axes = plt.subplots(rows, cols, figsize=figsize, squeeze=False,
                             constrained_layout=True, sharex=sharex)
    if title is not None:
        fig.suptitle(title, fontsize=18)
    return fig, axes


class Canvas:
    """One subplot accumulating semantic layers.

    Layers are drawn immediately; a legend proxy handle is recorded for every
    labeled layer in *push order* (duplicate labels collapse to the first).
    ``x_dtype`` (e.g. a datetime64 dtype) makes the canvas cast float64
    x-coordinates back to axis units at the matplotlib boundary, so data-prep
    code works purely in float64.
    """

    def __init__(self, ax, x_dtype=None, legend_into=None):
        self.ax = ax
        self.x_dtype = x_dtype
        # a twin-axis canvas shares its host's legend registry
        self._handles = legend_into._handles if legend_into is not None else {}

    # -- coordinate casting ---------------------------------------------
    def to_axis(self, x):
        """Cast float x-values to the axis dtype (identity for numeric)."""
        x = np.asarray(x)
        if self.x_dtype is not None and not np.issubdtype(x.dtype, self.x_dtype):
            return x.astype(np.float64).astype(self.x_dtype)
        return x

    # -- legend registry -------------------------------------------------
    def _register(self, label, role, patch=False):
        if label is None or label in self._handles:
            return
        plt = _plt()
        s = STYLES[role]
        if patch:
            import matplotlib.patches as patches
            self._handles[label] = patches.Patch(
                color=s["color"], alpha=s.get("alpha", 1.0), label=label)
        else:
            self._handles[label] = plt.Line2D(
                [0], [0], label=label,
                color=s["color"], linestyle=s.get("linestyle", "-"),
                linewidth=s.get("linewidth", 1.5),
                marker=s.get("marker", ""), markersize=s.get("markersize", 6))

    # -- layers ------------------------------------------------------------
    def points(self, x, y, role, label=None):
        s = STYLES[role]
        self.ax.plot(self.to_axis(x), y, linestyle="", marker=s["marker"],
                     markersize=s["markersize"], color=s["color"])
        self._register(label, role)
        return self

    def curve(self, x, y, role, label=None):
        s = STYLES[role]
        self.ax.plot(self.to_axis(x), y, color=s["color"],
                     linestyle=s.get("linestyle", "-"),
                     linewidth=s.get("linewidth", 1.5))
        self._register(label, role)
        return self

    def band(self, x, lo, hi, role, label=None):
        s = STYLES[role]
        self.ax.fill_between(self.to_axis(x), lo, hi, color=s["color"],
                             alpha=s.get("alpha", 0.3), linewidth=0)
        self._register(label, role, patch=True)
        return self

    def spans(self, ranges, role, label=None):
        """Shade vertical [x0, x1] ranges (e.g. removed data)."""
        s = STYLES[role]
        for x0, x1 in ranges:
            self.ax.axvspan(self.to_axis(x0), self.to_axis(x1),
                            color=s["color"], alpha=s.get("alpha", 0.3),
                            linewidth=0)
        if len(ranges):
            self._register(label, role, patch=True)
        return self

    def peaks(self, xs, role, label=None, height=0.05):
        """Short vertical markers at the bottom of the axes (PSD peaks)."""
        s = STYLES[role]
        for x in np.atleast_1d(xs):
            self.ax.axvline(x, ymin=0.001, ymax=height,
                            linewidth=s["linewidth"], color=s["color"])
        self._register(label, role)
        return self

    def errorbars(self, x, y, lo, hi):
        """Observation error whiskers (unlabeled background layer)."""
        self.ax.errorbar(self.to_axis(x), y, [y - lo, hi - y],
                         elinewidth=1.5, ecolor="lightgray", capsize=0,
                         linestyle="", marker="")
        return self

    # -- cosmetics -------------------------------------------------------
    def finish(self, xlim=None, xpad=0.001, xlabel=None, ylabel=None,
               title=None, legend=True, logx=False, logy=False,
               hide_yticks=False, label_size=14, title_size=16):
        ax = self.ax
        if xlim is not None:
            x0, x1 = (float(v) for v in xlim)
            pad = (x1 - x0) * xpad
            ax.set_xlim(self.to_axis(x0 - pad), self.to_axis(x1 + pad))
        if xlabel is not None:
            ax.set_xlabel(xlabel, fontsize=label_size)
        if ylabel is not None:
            ax.set_ylabel(ylabel, fontsize=label_size)
        if title is not None:
            ax.set_title(title, fontsize=title_size)
        if logx:
            ax.set_xscale("log")
        if logy:
            ax.set_yscale("log")
        if hide_yticks:
            ax.set_yticks([])
        if legend and self._handles:
            ax.legend(handles=list(self._handles.values()))
        return ax


def heatmap(fig, ax, M, vmin=None, vmax=None, colorbar=True, block=None,
            tick_labels=None, cell_text=False):
    """Symmetric-diverging matrix heatmap (Gram / correlation plots).

    ``block`` draws a major grid every `block` cells (channel boundaries in
    a multi-output Gram matrix); ``tick_labels`` puts channel names on both
    axes; ``cell_text`` annotates each cell with its value.
    """
    import matplotlib
    M = np.asarray(M)
    if vmax is None:
        vmax = float(np.abs(M).max())
    if vmin is None:
        vmin = -vmax
    norm = matplotlib.colors.Normalize(vmin=vmin, vmax=vmax)
    im = ax.matshow(M, cmap="coolwarm", norm=norm)

    if colorbar:
        from mpl_toolkits.axes_grid1 import make_axes_locatable
        cax = make_axes_locatable(ax).append_axes("right", size="5%", pad=0.3)
        fig.colorbar(im, cax=cax)

    if block is not None:
        edges = np.arange(-0.5, M.shape[0], block)
        ax.set_xticks(edges)
        ax.set_yticks(edges)
        ax.grid(which="major", linewidth=1.5, color="k")
        ax.set_xticklabels([])
        ax.set_yticklabels([])
        ax.tick_params(axis="both", which="both", length=0)

    if tick_labels is not None:
        ax.set_xticks(range(len(tick_labels)))
        ax.set_xticklabels(tick_labels, fontsize=14)
        ax.set_yticks(range(len(tick_labels)))
        ax.set_yticklabels(tick_labels, fontsize=14)
        ax.xaxis.set_ticks_position("top")

    if cell_text:
        for (i, j), v in np.ndenumerate(M):
            ax.text(j, i, "%0.3f" % v, ha="center", va="center", fontsize=14,
                    bbox=dict(boxstyle="round", facecolor="white", alpha=0.5,
                              edgecolor="0.9"))
    return im


def figure_legend(fig, entries):
    """Figure-level legend from (role, label) pairs in the style registry."""
    plt = _plt()
    handles = [plt.Line2D([0], [0], color=STYLES[role]["color"],
                          linestyle=STYLES[role].get("linestyle", "-"),
                          label=label)
               for role, label in entries]
    fig.legend(handles=handles)


def mixture_psd(x, means, scales, weights):
    """Spectral Gaussian-mixture density on grid ``x``.

    means/scales are (Q,) component location/width for one (channel, input
    dim); weights (Q,). Returns (per-component list of (n,) arrays, total).
    """
    x = np.asarray(x)[:, None]                          # (n, 1)
    mu = np.asarray(means)[None, :]                     # (1, Q)
    sd = np.asarray(scales)[None, :]
    w = np.asarray(weights)[None, :]
    comp = w * np.exp(-0.5 * ((x - mu) / sd) ** 2) / (sd * np.sqrt(2 * np.pi))
    return [comp[:, q] for q in range(comp.shape[1])], comp.sum(axis=1)


def normalize_density(y, x):
    """Scale ``y`` to integrate to 1 over the uniform grid ``x`` (in place
    semantics not required — returns the scaled array)."""
    return y / (y.sum() * (x[1] - x[0]))
