#!/usr/bin/env python3
"""Smoke test of mogptk_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from mogptk_tpu_torch/csrc/, holds each against its
plain PyTorch twin on the card at the shapes of the exact-GP predict path,
then serves three predict_y requests from the MOSM model that bench.py
builds (4 channels x 4,096 points, Q=2, float32) and checks the first against
a float64 reference computed on the card with the plain functions.

Prints the card's name and power limit, per-kernel errors and times, per-
request latencies, then one JSON line {"kernels": [...]} and, last, one
JSON line {"ok": true, "device": {...}}. Exits nonzero, with no result
line, when there is no CUDA device, when run without the repository beside
it, or when any check fails. Times come from CUDA events (kernels, median)
and from the host clock between synchronizations (requests).
"""
import json
import subprocess
import sys
import time

import numpy as np

N_PER_CHANNEL, CHANNELS, Q = 4096, 4, 2
TWO_POW_M24 = 2.0 ** -24


def make_data():
    """bench.py:40-49, the data of the model bench.py builds."""
    rng = np.random.RandomState(0)
    xs, ys = [], []
    for j in range(CHANNELS):
        x = np.sort(rng.uniform(0.0, 100.0, N_PER_CHANNEL)).reshape(-1, 1)
        y = (np.sin(0.5 * x[:, 0] + j) + 0.4 * np.cos(2.1 * x[:, 0])
             + 0.1 * rng.randn(N_PER_CHANNEL)).reshape(-1, 1)
        xs.append(x)
        ys.append(y)
    return xs, ys


def requests():
    """(a) 4 channels x 256, (b) 4 channels x 1,024, (c) 4,096 on channel 2;
    x in [0, 110], so part of every request extrapolates past the data."""
    rng = np.random.RandomState(7)

    def channel(c, m):
        return np.stack([np.full(m, float(c)), np.sort(rng.uniform(0.0, 110.0, m))], axis=1)

    return {"a": np.concatenate([channel(c, 256) for c in range(CHANNELS)]),
            "b": np.concatenate([channel(c, 1024) for c in range(CHANNELS)]),
            "c": channel(2, 4096)}


def fail(msg):
    raise RuntimeError(msg)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from mogptk_tpu_torch import gpr
    from mogptk_tpu_torch.ops import _build
    from mogptk_tpu_torch.ops import block_mosm as bm
    from mogptk_tpu_torch.ops import blocked_cholesky as bc
    from mogptk_tpu_torch.ops import mosm_gram as mg

    # -- phase 1: the card, the versions, the build ---------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("torch %s, CUDA %s, python %s" % (torch.__version__, torch.version.cuda,
                                             sys.version.split()[0]))
    print("allow_tf32: matmul=%s cudnn=%s" % (torch.backends.cuda.matmul.allow_tf32,
                                              torch.backends.cudnn.allow_tf32))
    t0 = time.perf_counter()
    _build.library()
    print("kernel build+load: %.1f s (%s)" % (time.perf_counter() - t0, _build.build()))

    dev = torch.device("cuda")
    gpr.use_single_precision()
    xs, ys = make_data()
    _, X, Y = gpr.merge_data(xs, ys, device=dev)
    kernel = gpr.MultiOutputSpectralMixtureKernel(Q, output_dims=CHANNELS)
    rng = np.random.RandomState(1)    # bench.py:56-58
    kernel.mean.assign(0.05 + 0.3 * rng.rand(CHANNELS, Q, 1))
    kernel.variance.assign(0.2 + 0.3 * rng.rand(CHANNELS, Q, 1))
    model = gpr.Exact(kernel, X, Y, variance=0.1, device=dev)
    reqs = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in requests().items()}
    n = X.shape[0]

    # -- phase 2: each kernel against its plain twin at the slice's shapes ----
    report = {}
    with torch.no_grad():
        c, x = model.kernel._split(model.X)
        cq, xq = model.kernel._split(reqs["b"])
        params = model.kernel._params()
        st3, st2 = bm.mosm_pair_stats(*params, model.kernel.twopi)
        for name, args in (("sorted Kff %dx%d" % (n, n), (x, c, x, c, st3, st2)),
                           ("cross Kfs %dx%d" % (n, xq.shape[0]), (x, c, xq, cq, st3, st2))):
            got = mg.mosm_gram(*args)
            ref = mg.mosm_gram_pairstats_plain(*args)
            err = float((got - ref).abs().max())
            # float32 cosines of arguments up to ~250 rad: one ulp of the
            # argument is ~1.5e-5 rad, and the two evaluation orders (FMA
            # contraction) differ by a few ulps
            tol = 2e-4 * float(ref.abs().max())
            ms = median_ms(lambda: mg.mosm_gram(*args))
            pms = median_ms(lambda: mg.mosm_gram_pairstats_plain(*args))
            print("K-gram %s: max_abs_err %.3e (tol %.3e), max|K| %.4f, kernel %.3f ms, plain %.3f ms"
                  % (name, err, tol, float(ref.abs().max()), ms, pms))
            if not err <= tol:
                fail("K-gram %s disagrees with its plain twin" % name)
            report.setdefault("mosm_gram", (err, ms, pms))
            del got, ref

        # K-spanel / K-colwrite at block column j=16 of the real factorization
        B, j = 512, 16
        r0 = j * B
        diag = model._noise_diag(add_jitter=True)
        K = bm.mosm_gram_sorted(x, model._channel_counts, *params, model.kernel.twopi)
        Lfull = torch.linalg.cholesky(K + torch.diag(diag))
        buf = K.clone()
        buf[:, :r0] = Lfull[:, :r0]          # finished left columns, K to the right
        del Lfull
        S = torch.empty((n, B), device=dev)
        S_ref = torch.empty((n, B), device=dev)
        bc.s_panel(buf, S, j, B)
        bc.s_panel_plain(buf, S_ref, j, B)
        m = n - r0
        A = buf[r0:, :r0].abs()
        bound = 2 * (r0 + 1) * TWO_POW_M24 * (A @ A[:B].T + buf[r0:, r0:r0 + B].abs())
        diff = (S[:m] - S_ref[:m]).abs()
        err = float(diff.max())
        ms = median_ms(lambda: bc.s_panel(buf, S, j, B))
        pms = median_ms(lambda: bc.s_panel_plain(buf, S_ref, j, B))
        print("K-spanel j=%d (m=%d, r0=%d, B=%d): max_abs_err %.3e, worst err/bound %.3f, "
              "kernel %.3f ms, plain %.3f ms" % (j, m, r0, B, err, float((diff / bound).max()), ms, pms))
        if not bool((diff <= bound).all()):
            fail("K-spanel disagrees with its plain twin beyond the summation bound")
        report["s_panel"] = (err, ms, pms)
        del A, bound, diff

        Sjj = S[:B] + torch.diag(diag[r0:r0 + B])
        Ljj = torch.linalg.cholesky(Sjj).contiguous()
        inv = torch.linalg.solve_triangular(Ljj, torch.eye(B, device=dev), upper=False).contiguous()
        for zero_upper in (True, False):
            L1, L2 = buf.clone(), buf.clone()
            bc.col_write(L1, S, Ljj, inv, j, B, zero_upper)
            bc.col_write_plain(L2, S, Ljj, inv, j, B, zero_upper)
            bound = float(2 * B * TWO_POW_M24 * (S[B:m].abs() @ inv.abs().T).max())
            err = float((L1 - L2).abs().max())
            ms = median_ms(lambda: bc.col_write(L1, S, Ljj, inv, j, B, zero_upper))
            pms = median_ms(lambda: bc.col_write_plain(L2, S, Ljj, inv, j, B, zero_upper))
            print("K-colwrite j=%d zero_upper=%s: max_abs_err %.3e (tol %.3e), kernel %.3f ms, plain %.3f ms"
                  % (j, zero_upper, err, bound, ms, pms))
            if not err <= bound:
                fail("K-colwrite disagrees with its plain twin")
            if zero_upper:
                report["col_write"] = (err, ms, pms)
            del L1, L2

        # the whole factorization, for orientation
        Kn = K + torch.diag(diag)
        del K, buf, S, S_ref
        fac = {}
        for name, fn in (("blocked (K-spanel + K-colwrite)", lambda A: bc.blocked_cholesky(A, 512)),
                         ("torch.linalg.cholesky", torch.linalg.cholesky)):
            times = []
            for _ in range(3):
                A = Kn.clone()
                times.append(event_ms(lambda: fn(A)))
                del A
            fac[name] = float(np.median(times))
        print("factorization n=%d: %s" % (n, ", ".join("%s %.2f ms" % kv for kv in fac.items())))
        del Kn
    torch.cuda.empty_cache()

    # -- phase 3: the slice, three predict_y requests -------------------------
    model.predict_y(reqs["a"], sigma=2)      # warm-up: library handles, workspaces
    counters = (mg.mosm_gram, bc.s_panel, bc.col_write)
    for f in counters:
        f.launches = 0
    answers = {}
    for key in ("a", "b", "c"):
        before = [f.launches for f in counters]
        torch.cuda.synchronize()
        t = time.perf_counter()
        mu, lo, up = model.predict_y(reqs[key], sigma=2)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        M = reqs[key].shape[0]
        for out in (mu, lo, up):
            if out.shape != (M, 1) or not bool(torch.isfinite(out).all()):
                fail("request (%s): non-finite or misshapen answer" % key)
        if not bool((lo < mu).all() and (mu < up).all()):
            fail("request (%s): bands do not bracket the mean" % key)
        raised = [f.launches - b for f, b in zip(counters, before)]
        print("request (%s) M=%d: %.2f ms, launches gram/spanel/colwrite %s"
              % (key, M, ms, raised))
        if min(raised) < 1:
            fail("request (%s) did not go through every kernel" % key)
        answers[key] = mu
    launches = {f.__name__: f.launches for f in counters}

    # request (a) against a float64 reference on the card, plain functions only
    with torch.no_grad():
        mu32, var32 = model.predict_f(reqs["a"])
        mu64, var64 = float64_reference(model, reqs["a"], bm, mg)
        dmu = float((mu32.double() - mu64).abs().max())
        dvar = float((var32.double() - var64).abs().max())
        kss = float(model.kernel.K_diag(reqs["a"]).max())
        # noise variance 0.1 bounds the smallest eigenvalue of K + σ²I below
        # by 0.1 and trace(K) ~ 3e4 bounds the largest: κ ≲ 3e5, so float32
        # (u = 6e-8) can lose up to κ·u ~ 2e-2 relative in the solves;
        # the tolerance is 1e-2 of each output's scale
        tol_mu = 1e-2 * float(mu64.abs().max())
        tol_var = 1e-2 * kss
        print("request (a) vs float64 reference: max|dmu| %.3e (tol %.3e), max|dvar| %.3e (tol %.3e)"
              % (dmu, tol_mu, dvar, tol_var))
        if not (dmu <= tol_mu and dvar <= tol_var):
            fail("request (a) disagrees with the float64 reference")
        if not torch.allclose(answers["a"], mu32):
            fail("request (a) is not reproducible")

    kernels = [
        {"name": "mosm_gram", "route": "cuda", "source": "mogptk_tpu_torch/csrc/mosm_gram.cu",
         "replaces": "mogptk_tpu/ops/block_mosm.py:304; mogptk_tpu/ops/pallas_mosm.py:207"},
        {"name": "s_panel", "route": "cuda", "source": "mogptk_tpu_torch/csrc/blocked_cholesky.cu",
         "replaces": "mogptk_tpu/ops/blocked_cholesky.py:96"},
        {"name": "col_write", "route": "cuda", "source": "mogptk_tpu_torch/csrc/blocked_cholesky.cu",
         "replaces": "mogptk_tpu/ops/blocked_cholesky.py:292; mogptk_tpu/ops/blocked_cholesky.py:184"},
    ]
    for k in kernels:
        err, ms, pms = report[k["name"]]
        k.update(launches=launches[k["name"]], max_abs_err=err, ms=ms, plain_ms=pms)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def float64_reference(model, Xq, bm, mg):
    """predict_f of `model` at Xq in float64 with the plain Gram and
    torch.linalg (no hand-written kernel)."""
    import torch
    kern = model.kernel
    params = [p.double() for p in kern._params()]
    st3, st2 = bm.mosm_pair_stats(*params, kern.twopi)
    c, x = kern._split(model.X.double())
    cq, xq = kern._split(Xq.double())
    Kff = mg.mosm_gram_pairstats_plain(x, c, x, c, st3, st2)
    Kfs = mg.mosm_gram_pairstats_plain(x, c, xq, cq, st3, st2)
    noise = model.likelihood.scale().double() ** 2
    alpha = params[0] ** 2 * kern.twopi * torch.sqrt(torch.prod(params[2], dim=-1))
    kdiag = torch.sum(alpha, dim=-1)
    diag = noise + model.jitter * torch.mean(kdiag[c.long()] + noise)
    Kff.diagonal().add_(diag)
    L = torch.linalg.cholesky(Kff)
    del Kff
    v = torch.linalg.solve_triangular(L, Kfs, upper=False)
    mu = Kfs.T @ torch.cholesky_solve(model.y.double(), L, upper=False)
    var = (kdiag[cq.long()] - torch.sum(v * v, dim=0)).reshape(-1, 1)
    return mu, var


def event_ms(fn):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    return float(np.median([event_ms(fn) for _ in range(reps)]))


if __name__ == "__main__":
    sys.exit(main())
