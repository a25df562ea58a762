#!/usr/bin/env python3
"""Smoke test of mogptk_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # the checks below
    python3 chip_smoke.py --profile  # also torch.profiler over one training step

Builds the CUDA kernels from mogptk_tpu_torch/csrc/, holds each against its
plain PyTorch twin on the card at the shapes of the two paths it drives, on
the MOSM model that bench.py builds (4 channels x 4,096 points, Q=2, float32):

- serving: three predict_y requests, the first checked against a float64
  reference computed on the card with the plain functions;
- training: Exact(trace_probes=16) steps of gpr.train (LML, probe-trace
  gradient through the K-gram-lower, K-spanel, K-colwrite, K-solve and
  K-lowrank-vjp kernels, one Adam update), the first step's LML and gradient
  checked against a float64 reference on the card, the first step repeated
  for an identical loss, then six steps;
- closed-form training: K-gram-bwd against its twin on the first step's
  dense cotangent (channel-sorted, and the same points permuted), then
  Exact(trace_probes=None) steps (K-gram, K-spanel, K-colwrite, K-solve, the
  inverse from the factor and K-gram-bwd), checked as above;
- the user API: mogptk_tpu_torch.MOSM on a DataSet of the same data trains
  six steps with the default Exact(), predicts and scores itself; a second
  MOSM initializes by BNSE.

Prints the card's name and power limit, per-kernel errors and times, per-
request and per-step times, then one JSON line {"kernels": [...]} and, last,
one JSON line {"ok": true, "device": {...}}. Exits nonzero, with no result
line, when there is no CUDA device, when run without the repository beside
it, or when any check fails. Times come from CUDA events (kernels, median of
10) and from the host clock between synchronizations (requests, steps).
Bounds use the H100 SXM's published peaks: 3.35 TB/s and 67 TFLOP/s FP32
outside the tensor cores.
"""
import json
import subprocess
import sys
import time

import numpy as np

N_PER_CHANNEL, CHANNELS, Q = 4096, 4, 2
PROBES, TRAIN_STEPS = 16, 6
TWO_POW_M24 = 2.0 ** -24
PEAK_BYTES_PER_S, PEAK_FP32_PER_S = 3.35e12, 67e12
# noise variance 0.1 bounds the smallest eigenvalue of K + σ²I below by 0.1
# and trace(K) ~ 3e4 bounds the largest: κ ≲ 3e5, and float32 (u = 6e-8)
# can lose up to κ·u ~ 2e-2 relative in the factor and the solves
KAPPA_U = 2e-2


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


def set_bench_params(kernel):
    """bench.py:56-58, the kernel parameters bench.py sets."""
    rng = np.random.RandomState(1)
    kernel.mean.assign(0.05 + 0.3 * rng.rand(CHANNELS, Q, 1))
    kernel.variance.assign(0.2 + 0.3 * rng.rand(CHANNELS, Q, 1))


def bench_model(gpr, X, Y, dev, trace_probes):
    """The model bench.py builds (bench.py:52-60), with noise variance 0.1."""
    kernel = gpr.MultiOutputSpectralMixtureKernel(Q, output_dims=CHANNELS)
    set_bench_params(kernel)
    return gpr.Exact(kernel, X, Y, variance=0.1, trace_probes=trace_probes, device=dev)


T_START = time.perf_counter()


def phase(name):
    print("-- %s (%.1f s)" % (name, time.perf_counter() - T_START), flush=True)


def bound(nbytes, nops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the FP32 operations over the FP32 peak."""
    b, o = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * nops / PEAK_FP32_PER_S
    return (b, "bytes") if b >= o else (o, "operations")


def gram_ops(elements, D):
    """FP32 operations of the MOSM Gram per element count (the τ chain 6 per
    input dim, then exp, cos and 5 more per component, a transcendental
    function counted as one operation)."""
    return elements * Q * (6 * D + 7)


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
    from mogptk_tpu_torch.ops import blocked_trisolve as bt
    from mogptk_tpu_torch.ops import fused_solve as fs
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
    lib = _build.build()
    print("kernel build+load: %.1f s (%s)" % (time.perf_counter() - t0, lib))
    print_ptxas_report(lib)

    dev = torch.device("cuda")
    gpr.use_single_precision()
    xs, ys = make_data()
    _, X, Y = gpr.merge_data(xs, ys, device=dev)
    model = bench_model(gpr, X, Y, dev, PROBES)
    reqs = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in requests().items()}
    n = X.shape[0]
    D = 1

    # -- phase 2: the serving kernels against their plain twins ---------------
    phase("phase 2: serving kernels against their twins")
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
            elems = args[0].shape[0] * args[2].shape[0]
            bnd = bound(4 * elems, gram_ops(elems, D))
            print("K-gram %s: max_abs_err %.3e (tol %.3e), max|K| %.4f, kernel %.3f ms, plain %.3f ms, "
                  "bound %.3f ms (%s)" % ((name, err, tol, float(ref.abs().max()), ms, pms) + bnd))
            if not err <= tol:
                fail("K-gram %s disagrees with its plain twin" % name)
            if "mosm_gram" not in report:
                report["mosm_gram"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
                                           bound=bnd)
            del got, ref

        # K-spanel / K-colwrite at block column j=16 of the real factorization
        B, j = 512, 16
        r0 = j * B
        m = n - r0
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
        A = buf[r0:, :r0].abs()
        tolS = 2 * (r0 + 1) * TWO_POW_M24 * (A @ A[:B].T + buf[r0:, r0:r0 + B].abs())
        diff = (S[:m] - S_ref[:m]).abs()
        err = float(diff.max())
        ms = median_ms(lambda: bc.s_panel(buf, S, j, B))
        pms = median_ms(lambda: bc.s_panel_plain(buf, S_ref, j, B))
        lms = median_ms(lambda: torch.addmm(buf[r0:, r0:r0 + B], buf[r0:, :r0], buf[r0:r0 + B, :r0].T,
                                            alpha=-1.0))
        bnd = bound(4 * (m * r0 + 2 * m * B), 2 * m * B * r0)
        print("K-spanel j=%d (m=%d, r0=%d, B=%d): max_abs_err %.3e, worst err/bound %.3f, "
              "kernel %.3f ms, plain %.3f ms, cuBLAS addmm %.3f ms, bound %.3f ms (%s)"
              % ((j, m, r0, B, err, float((diff / tolS).max()), ms, pms, lms) + bnd))
        if not bool((diff <= tolS).all()):
            fail("K-spanel disagrees with its plain twin beyond the summation bound")
        report["s_panel"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms, bound=bnd)
        del A, tolS, diff

        Sjj = S[:B] + torch.diag(diag[r0:r0 + B])
        Ljj = torch.linalg.cholesky(Sjj).contiguous()
        inv = torch.linalg.solve_triangular(Ljj, torch.eye(B, device=dev), upper=False).contiguous()
        for zero_upper in (True, False):
            L1, L2 = buf.clone(), buf.clone()
            bc.col_write(L1, S, Ljj, inv, j, B, zero_upper)
            bc.col_write_plain(L2, S, Ljj, inv, j, B, zero_upper)
            tolC = float(2 * B * TWO_POW_M24 * (S[B:m].abs() @ inv.abs().T).max())
            err = float((L1 - L2).abs().max())
            ms = median_ms(lambda: bc.col_write(L1, S, Ljj, inv, j, B, zero_upper))
            pms = median_ms(lambda: bc.col_write_plain(L2, S, Ljj, inv, j, B, zero_upper))
            lms = median_ms(lambda: torch.matmul(S[B:m], inv.T))
            nbytes = 4 * (2 * m * B + 2 * B * B + (B * (n - r0 - B) if zero_upper else 0))
            bnd = bound(nbytes, 2 * (m - B) * B * B)
            print("K-colwrite j=%d zero_upper=%s: max_abs_err %.3e (tol %.3e), kernel %.3f ms, "
                  "plain %.3f ms, torch.matmul S·invT %.3f ms, bound %.3f ms (%s)"
                  % ((j, zero_upper, err, tolC, ms, pms, lms) + bnd))
            if not err <= tolC:
                fail("K-colwrite disagrees with its plain twin")
            entry = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms, bound=bnd)
            report["col_write" if zero_upper else "col_write (zero_upper=False)"] = entry
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

    # -- phase 3: the serving path, three predict_y requests ------------------
    phase("phase 3: serving path")
    model.predict_y(reqs["a"], sigma=2)      # warm-up: library handles, workspaces
    serve_counters = {"mosm_gram": mg.mosm_gram, "s_panel": bc.s_panel,
                      "col_write": bc.col_write}
    for f in serve_counters.values():
        f.launches = 0
    answers = {}
    for key in ("a", "b", "c"):
        before = [f.launches for f in serve_counters.values()]
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
        raised = [f.launches - b for f, b in zip(serve_counters.values(), before)]
        print("request (%s) M=%d: %.2f ms, launches gram/spanel/colwrite %s"
              % (key, M, ms, raised))
        if min(raised) < 1:
            fail("request (%s) did not go through every kernel" % key)
        answers[key] = mu
    serve_launches = {k: f.launches for k, f in serve_counters.items()}

    # request (a) against a float64 reference on the card, plain functions only
    with torch.no_grad():
        mu32, var32 = model.predict_f(reqs["a"])
        mu64, var64 = float64_reference(model, reqs["a"], bm, mg)
        dmu = float((mu32.double() - mu64).abs().max())
        dvar = float((var32.double() - var64).abs().max())
        kss = float(model.kernel.K_diag(reqs["a"]).max())
        # κ·u ~ 2e-2 relative in the solves (KAPPA_U); the tolerance is 1e-2
        # of each output's scale
        tol_mu = 1e-2 * float(mu64.abs().max())
        tol_var = 1e-2 * kss
        print("request (a) vs float64 reference: max|dmu| %.3e (tol %.3e), max|dvar| %.3e (tol %.3e)"
              % (dmu, tol_mu, dvar, tol_var))
        if not (dmu <= tol_mu and dvar <= tol_var):
            fail("request (a) disagrees with the float64 reference")
        if not torch.allclose(answers["a"], mu32):
            fail("request (a) is not reproducible")
    torch.cuda.empty_cache()

    # -- phase 4: the training kernels against their plain twins ---------------
    phase("phase 4: training kernels against their twins")
    counts = model._channel_counts
    band = bc.effective_block(n, gpr.config.blocked_cholesky_block)
    with torch.no_grad():
        st3, st2 = bm.mosm_pair_stats(*model.kernel._params(), model.kernel.twopi)
        Kl = bm.mosm_gram_sorted_lower(x, counts, st3, st2, band=band)
        ref = bm.mosm_gram_sorted_lower_plain(x, c, st3, st2, band)
        written = ~torch.isnan(ref)
        err = float((Kl - ref)[written].abs().max())
        tol = 2e-4 * float(ref[written].abs().max())   # as K-gram
        nw = int(written.sum())
        del written, ref
        ms = median_ms(lambda: bm.mosm_gram_sorted_lower(x, counts, st3, st2, band=band))
        pms = median_ms(lambda: bm.mosm_gram_sorted_lower_plain(x, c, st3, st2, band))
        bnd = bound(4 * nw, gram_ops(nw, D))
        print("K-gram-lower %dx%d, band %d, %d written elements: max_abs_err %.3e (tol %.3e), "
              "kernel %.3f ms, plain %.3f ms, bound %.3f ms (%s)"
              % ((n, n, band, nw, err, tol, ms, pms) + bnd))
        if not err <= tol:
            fail("K-gram-lower disagrees with its plain twin on the written tiles")
        report["mosm_gram_lower"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
                                         bound=bnd)

        # K-solve on the real factor (upper left as the factorization leaves it)
        diag = model._noise_diag(add_jitter=True)
        L, invs = bc.blocked_cholesky(Kl, band, diag_shift=diag, zero_upper=False,
                                      return_panel_invs=True)
        rhs = torch.cat([model.y, model.probes], dim=1)
        R1 = rhs.shape[1]
        Xk = fs.fused_cho_solve(L, invs, rhs)
        Xt = bt.blocked_cho_solve(L, rhs, invs=invs)
        Lc = torch.tril(L)
        X64 = torch.cholesky_solve(rhs.double(), Lc.double(), upper=False)
        err_k = float((Xk.double() - X64).abs().max())
        err_t = float((Xt.double() - X64).abs().max())
        # both float32 sweeps lose ~κ·u of the solution's scale to rounding in
        # different orders; the kernel may be at most twice as far off as the
        # twin, plus a floor of 1e-6 of the scale for summation order alone
        tol = 2 * err_t + 1e-6 * float(X64.abs().max())
        err = float((Xk - Xt).abs().max())
        ms = median_ms(lambda: fs.fused_cho_solve(L, invs, rhs))
        pms = median_ms(lambda: bt.blocked_cho_solve(L, rhs, invs=invs))
        lms = median_ms(lambda: torch.cholesky_solve(rhs, Lc, upper=False))
        nb = invs.shape[0]
        bnd = bound(4 * (n * (n + 1) // 2 + nb * band * band + 2 * n * R1),
                    2 * R1 * (n * n - nb * band * band) + 4 * R1 * nb * band * band)
        print("K-solve n=%d, %d panels, %d columns: vs float64 %.3e (twin %.3e, tol %.3e), "
              "vs twin %.3e, kernel %.3f ms, plain %.3f ms, torch.cholesky_solve %.3f ms, "
              "bound %.3f ms (%s)" % ((n, nb, R1, err_k, err_t, tol, err, ms, pms, lms) + bnd))
        if not err_k <= tol:
            fail("K-solve is further from the float64 solve than twice its plain twin")
        report["fused_cho_solve"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms,
                                         bound=bnd)
        del Lc, X64, Xt, L, Kl
        torch.cuda.empty_cache()

        # K-lowrank-vjp on the first step's A, B (g = 1)
        alpha, U = Xk[:, :1], Xk[:, 1:]
        A = 0.5 * torch.cat([alpha, -U / PROBES], dim=1)
        Bm = torch.cat([alpha, model.probes], dim=1)
        twopi = model.kernel.twopi
        params = [p.detach() for p in model.kernel._params()]
        got = bm.pair_stats_vjp(params, twopi, *bm.mosm_lowrank_vjp_sorted(x, counts, st3, st2, A, Bm))
        twin = bm.pair_stats_vjp(params, twopi, *bm.mosm_lowrank_vjp_plain(x, counts, st3, st2, A, Bm))
        p64 = [p.double() for p in params]
        st64 = bm.mosm_pair_stats(*p64, twopi)
        ref = bm.pair_stats_vjp(p64, twopi, *bm.mosm_lowrank_vjp_plain(
            x.double(), counts, *st64, A.double(), Bm.double()))
        scale = max(float(r.abs().max()) for r in ref)
        err_k = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
        err_t = max(float((g.double() - r).abs().max()) for g, r in zip(twin, ref))
        err = max(float((g - t).abs().max()) for g, t in zip(got, twin))
        # float32 sums over 2.7e8 elements in two orders; at most twice the
        # twin's error against float64, plus a floor of 1e-5 of the scale
        tol = 2 * err_t + 1e-5 * scale
        ms = median_ms(lambda: bm.mosm_lowrank_vjp_sorted(x, counts, st3, st2, A, Bm))
        pms = median_ms(lambda: bm.mosm_lowrank_vjp_plain(x, counts, st3, st2, A, Bm))
        idx, _ = bm._pair_layout(tuple(counts), bm.BWD_TILE)
        sym = int((idx[:, 0] != idx[:, 1]).sum())
        tile = bm.BWD_TILE ** 2
        ops = (tile * R1 * (4 * sym + 2 * (idx.shape[0] - sym))
               + tile * idx.shape[0] * Q * (18 * D + 16))
        bnd = bound(4 * n * (2 * R1 + D), ops)
        print("K-lowrank-vjp %d tiles of %d^2 (R=%d): parameter cotangents vs float64 %.3e "
              "(twin %.3e, tol %.3e, scale %.3e), vs twin %.3e, kernel %.3f ms, plain %.3f ms, "
              "bound %.3f ms (%s)"
              % ((idx.shape[0], bm.BWD_TILE, R1, err_k, err_t, tol, scale, err, ms, pms) + bnd))
        if not err_k <= tol:
            fail("K-lowrank-vjp is further from float64 than twice its plain twin")
        report["mosm_lowrank_vjp"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
                                          bound=bnd)
        del A, Bm, Xk, got, twin, ref
    torch.cuda.empty_cache()

    # -- phase 5: the training path ------------------------------------------
    phase("phase 5: training path")
    train_counters = {"mosm_gram_lower": bm.mosm_gram_sorted_lower, "s_panel": bc.s_panel,
                      "col_write": bc.col_write, "fused_cho_solve": fs.fused_cho_solve,
                      "mosm_lowrank_vjp": bm.mosm_lowrank_vjp_sorted}
    want = {"mosm_gram_lower": (1, 1), "s_panel": (32, 32), "col_write": (32, 32),
            "fused_cho_solve": (1, None), "mosm_lowrank_vjp": (1, 1)}
    loss1 = check_first_step(model, bm, mg, "probe-trace")
    if "--profile" in sys.argv[1:]:
        profile_step(model)
    train_launches = train_and_count(gpr, model, train_counters, want, loss1, "probe-trace", smi)
    del model
    torch.cuda.empty_cache()

    # -- phase 6: K-gram-bwd against its plain twin ----------------------------
    t_added = time.perf_counter()
    phase("phase 6: K-gram-bwd against its twin")
    model = bench_model(gpr, X, Y, dev, None)
    report["mosm_gram_bwd"] = check_gram_bwd(model, bm, mg)
    torch.cuda.empty_cache()

    # -- phase 7: the closed-form training path -------------------------------
    phase("phase 7: closed-form training path")
    cf_counters = {"mosm_gram": mg.mosm_gram, "mosm_gram_bwd": mg.mosm_gram_bwd,
                   "s_panel": bc.s_panel, "col_write": bc.col_write,
                   "fused_cho_solve": fs.fused_cho_solve,
                   "mosm_gram_lower": bm.mosm_gram_sorted_lower,
                   "mosm_lowrank_vjp": bm.mosm_lowrank_vjp_sorted}
    cf_want = {"mosm_gram": (1, 1), "mosm_gram_bwd": (1, 1), "s_panel": (32, 32),
               "col_write": (32, 32), "fused_cho_solve": (1, None),
               "mosm_gram_lower": (0, 0), "mosm_lowrank_vjp": (0, 0)}
    loss1 = check_first_step(model, bm, mg, "closed-form")
    if "--profile" in sys.argv[1:]:
        profile_step(model)
    cf_launches = train_and_count(gpr, model, cf_counters, cf_want, loss1, "closed-form", smi)
    del model
    torch.cuda.empty_cache()

    # -- phase 8: the user API at full width ---------------------------------
    phase("phase 8: user API (DataSet, MOSM, train, predict, error, BNSE)")
    drive_user_api(xs, ys, cf_counters)
    print("phases 6-8 (K-gram-bwd, closed-form training, user API) wall time: %.1f s"
          % (time.perf_counter() - t_added))

    sources = {"cuda_gram": "mogptk_tpu_torch/csrc/mosm_gram.cu",
               "chol": "mogptk_tpu_torch/csrc/blocked_cholesky.cu"}
    kernels = [
        {"name": "mosm_gram", "route": "cuda", "source": sources["cuda_gram"],
         "replaces": "mogptk_tpu/ops/block_mosm.py:304; mogptk_tpu/ops/pallas_mosm.py:207",
         "path": "predict", "launches": serve_launches["mosm_gram"]},
        {"name": "s_panel", "route": "cuda", "source": sources["chol"],
         "replaces": "mogptk_tpu/ops/blocked_cholesky.py:96",
         "path": "train", "launches": train_launches["s_panel"]},
        {"name": "col_write", "route": "cuda", "source": sources["chol"],
         "replaces": "mogptk_tpu/ops/blocked_cholesky.py:292; mogptk_tpu/ops/blocked_cholesky.py:184",
         "path": "train", "launches": train_launches["col_write"]},
        {"name": "mosm_gram_lower", "route": "cuda", "source": sources["cuda_gram"],
         "replaces": "mogptk_tpu/ops/block_mosm.py:437",
         "path": "train", "launches": train_launches["mosm_gram_lower"]},
        {"name": "fused_cho_solve", "route": "cuda",
         "source": "mogptk_tpu_torch/csrc/fused_cho_solve.cu",
         "replaces": "mogptk_tpu/ops/pallas_solve.py:186",
         "path": "train", "launches": train_launches["fused_cho_solve"]},
        {"name": "mosm_lowrank_vjp", "route": "cuda",
         "source": "mogptk_tpu_torch/csrc/mosm_lowrank_vjp.cu",
         "replaces": "mogptk_tpu/ops/block_mosm.py:652",
         "path": "train", "launches": train_launches["mosm_lowrank_vjp"]},
        {"name": "mosm_gram_bwd", "route": "cuda",
         "source": "mogptk_tpu_torch/csrc/mosm_gram_bwd.cu",
         "replaces": "mogptk_tpu/ops/block_mosm.py:345; mogptk_tpu/ops/pallas_mosm.py:274",
         "path": "train", "launches": cf_launches["mosm_gram_bwd"]},
    ]
    for k in kernels:
        r = report[k["name"]]
        k.update(max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                 bound_ms=r["bound"][0], bound_by=r["bound"][1], library_ms=r["library_ms"])
    phase("done")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def check_gram_bwd(model, bm, mg):
    """K-gram-bwd against its plain twin on the first closed-form step's
    dense cotangent dK = ½(ααᵀ − K⁻¹) of `model`, channel-sorted and with the
    points permuted, each against a float64 evaluation of the twin. Returns
    the channel-sorted call's report entry."""
    import torch
    from mogptk_tpu_torch.ops import linalg as la
    n, dev, D = model.X.shape[0], model.X.device, model.kernel.input_dims
    with torch.no_grad():
        c, x = model.kernel._split(model.X)
        counts = model._channel_counts
        params = [p.detach() for p in model.kernel._params()]
        st3, st2 = bm.mosm_pair_stats(*params, model.kernel.twopi)
        K = bm.mosm_gram_sorted(x, counts, *params, model.kernel.twopi)
        _, L, invs, alpha = la._chol_lml(K, model._noise_diag(add_jitter=True), model.y)
        G, _ = la._dense_lml_cotangents(L, alpha, 1.0, invs)   # the first step's dK (g = 1)
        del K, L, invs, alpha
        ref = mg.mosm_gram_bwd_plain(x.double(), c, x.double(), c, st3.double(), st2.double(),
                                     G.double())
        scale = max(float(r.abs().max()) for r in ref)
        perm = torch.as_tensor(np.random.RandomState(3).permutation(n), device=dev)
        xp, cp = x[perm].contiguous(), c[perm].contiguous()
        Gp = G[perm][:, perm].contiguous()
        for label, args, cnt in (("channel-sorted", (x, c, x, c, st3, st2, G), counts),
                                 ("permuted", (xp, cp, xp, cp, st3, st2, Gp), None)):
            got = mg.mosm_gram_bwd(*args, cnt, cnt)
            twin = mg.mosm_gram_bwd_plain(*args)
            err_k = max(float((a.double() - r).abs().max()) for a, r in zip(got, ref))
            err_t = max(float((a.double() - r).abs().max()) for a, r in zip(twin, ref))
            err = max(float((a - b).abs().max()) for a, b in zip(got, twin))
            # float32 sums over 2.7e8 elements in two orders: at most twice the
            # twin's error against float64, plus a floor of 1e-5 of the scale
            tol = 2 * err_t + 1e-5 * scale
            ms = median_ms(lambda: mg.mosm_gram_bwd(*args, cnt, cnt))
            pms = median_ms(lambda: mg.mosm_gram_bwd_plain(*args), reps=3, warmup=1)
            bnd = bound(4 * n * n + 4 * n * (2 * D + 2), n * n * Q * (18 * D + 16))
            print("K-gram-bwd %s %dx%d: pair cotangents vs float64 %.3e (twin %.3e, tol %.3e, "
                  "scale %.3e), vs twin %.3e, kernel %.3f ms, plain %.3f ms, bound %.3f ms (%s)"
                  % ((label, n, n, err_k, err_t, tol, scale, err, ms, pms) + bnd))
            if not err_k <= tol:
                fail("K-gram-bwd (%s) is further from float64 than twice its plain twin" % label)
            if label == "channel-sorted":
                entry = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None, bound=bnd)
            del got, twin
    return entry


def drive_user_api(xs, ys, counters):
    """The quick start at full width: DataSet → MOSM (default Exact()) →
    train → predict → error, then a second MOSM initialized by BNSE. Fails
    unless training went through K-gram and K-gram-bwd once a step and every
    answer is finite and plausible."""
    import torch
    import mogptk_tpu_torch as mogptk
    ds = mogptk.DataSet([xc[:, 0] for xc in xs], [yc[:, 0] for yc in ys])
    api = mogptk.MOSM(ds, Q=Q)
    if api.gpr.trace_probes is not None or api.gpr.X.device.type != "cuda":
        fail("MOSM did not build the default Exact() on the card")
    set_bench_params(api.gpr.kernel)
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses, _ = api.train(method="Adam", lr=0.01, iters=TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    raised = {k: f.launches for k, f in counters.items()}
    steps = np.diff(api.times)
    print("MOSM.train(Adam, lr=0.01, iters=%d) at N=%d: %.2f s, losses %s, step ms %s, "
          "launches %s" % (TRAIN_STEPS, api.gpr.X.shape[0], train_s, np.round(losses, 4).tolist(),
                           np.round(1e3 * steps, 2).tolist(), raised))
    if not np.all(np.isfinite(losses)):
        fail("MOSM.train gave a non-finite loss")
    if raised["mosm_gram_bwd"] != TRAIN_STEPS or raised["mosm_gram"] != TRAIN_STEPS + 1:
        fail("MOSM.train did not go through K-gram and K-gram-bwd once a step")
    torch.cuda.synchronize()
    t = time.perf_counter()
    Xp, Mu, Lo, Up = api.predict()
    predict_ms = 1e3 * (time.perf_counter() - t)
    for j in range(CHANNELS):
        if Mu[j].shape != (N_PER_CHANNEL,) or not np.all(np.isfinite(Mu[j])):
            fail("MOSM.predict: channel %d is non-finite or misshapen" % j)
        if not (np.all(Lo[j] < Mu[j]) and np.all(Mu[j] < Up[j])):
            fail("MOSM.predict: channel %d's bands do not bracket the mean" % j)
    t = time.perf_counter()
    mae = api.error("MAE")
    error_ms = 1e3 * (time.perf_counter() - t)
    print("MOSM.predict() over %d points: %.2f ms; error('MAE') = %.6f in %.2f ms"
          % (api.gpr.X.shape[0], predict_ms, mae, error_ms))
    # a fitted model predicts its training points better than their mean does
    yall = np.concatenate(ys)
    if not (np.isfinite(mae) and mae < np.mean(np.abs(yall - yall.mean()))):
        fail("MOSM.error('MAE') = %r is not a fit" % mae)
    del api
    torch.cuda.empty_cache()
    t = time.perf_counter()
    bnse = mogptk.MOSM(ds, Q=Q)
    bnse.init_parameters("BNSE", iters=20)
    torch.cuda.synchronize()
    vals = [p.numpy() for p in bnse.parameters()]
    print("MOSM.init_parameters('BNSE', iters=20) over %d channels of %d points: %.2f s; "
          "weights %s" % (CHANNELS, N_PER_CHANNEL, time.perf_counter() - t,
                          np.round(bnse.gpr.kernel.weight.numpy(), 4).tolist()))
    if not all(np.all(np.isfinite(v)) for v in vals):
        fail("BNSE initialization gave non-finite parameters")
    del bnse


def check_first_step(model, bm, mg, label):
    """The model's first training step (loss and every raw's gradient)
    against float64_training_reference within κ·u, then once more for a
    bit-identical loss and gradient. Returns the first loss."""
    import torch
    raws = model.trainable_raws()
    for r in raws:
        r.grad = None
    loss = model.loss()
    loss.backward()
    torch.cuda.synchronize()
    loss1 = float(loss.detach())
    grads1 = [r.grad.clone() for r in raws]
    phase("%s: float64 reference of the first step" % label)
    lml64, grads64, scale_lml = float64_training_reference(model, bm, mg)
    d_lml = abs(-loss1 - lml64)
    tol_lml = KAPPA_U * scale_lml
    g_scale = max(float(g.abs().max()) for g in grads64)
    d_grad = max(float((g.double() - r).abs().max()) for g, r in zip(grads1, grads64))
    tol_grad = KAPPA_U * g_scale
    print("%s first step vs float64 reference: LML %.6f vs %.6f, |d| %.3e (tol κu·%.1f = %.3e); "
          "gradient max|d| %.3e (tol κu·max|g| = %.3e, max|g| %.3e)"
          % (label, -loss1, lml64, d_lml, scale_lml, tol_lml, d_grad, tol_grad, g_scale))
    if not (d_lml <= tol_lml and d_grad <= tol_grad):
        fail("the first %s training step disagrees with the float64 reference" % label)
    for r in raws:
        r.grad = None
    loss = model.loss()
    loss.backward()
    if float(loss.detach()) != loss1 or not all(torch.equal(r.grad, g) for r, g in zip(raws, grads1)):
        fail("a repeated first %s step gave another loss or gradient" % label)
    print("%s repeated first step: identical loss %.9g and gradients" % (label, loss1))
    for r in raws:
        r.grad = None
    return loss1


def train_and_count(gpr, model, counters, want, loss1, label, smi):
    """TRAIN_STEPS Adam steps of gpr.train with every count set to 0 first;
    each step must launch each kernel as `want` says ((least, exact or
    None)). Returns the counts of the whole run."""
    import torch
    phase("%s: %d training steps" % (label, TRAIN_STEPS))
    for f in counters.values():
        f.launches = 0
    stamps = []

    def on_step(i, value):
        stamps.append((time.perf_counter(), value, {k: f.launches for k, f in counters.items()}))

    torch.cuda.synchronize()
    t_start = time.perf_counter()
    losses, _ = gpr.train(model, method="Adam", lr=1e-3, iters=TRAIN_STEPS, callback=on_step)
    launches = {k: f.launches for k, f in counters.items()}
    prev_t, prev_c = t_start, {k: 0 for k in counters}
    step_ms = []
    for i, (t, value, cnt) in enumerate(stamps):
        raised = {k: cnt[k] - prev_c[k] for k in cnt}
        step_ms.append(1e3 * (t - prev_t))
        print("%s train step %d: loss %.6f, %.2f ms, launches %s" % (label, i, value, step_ms[-1], raised))
        if not np.isfinite(value):
            fail("%s train step %d: loss is not finite" % (label, i))
        for k, (lo, hi) in want.items():
            if raised[k] < lo or (hi is not None and raised[k] != hi):
                fail("%s train step %d launched %s %d times" % (label, i, k, raised[k]))
        prev_t, prev_c = t, cnt
    if abs(losses[0] - loss1) > 0:
        fail("the first %s train step's loss differs from the checked first step" % label)
    med = float(np.median(step_ms[1:]))
    print("%s training: %d Adam steps at N=%d, median step %.2f ms, %.3f steps/s (%s)"
          % (label, TRAIN_STEPS, model.X.shape[0], med, 1e3 / med, smi.stdout.strip().splitlines()[0]))
    return launches


def print_ptxas_report(lib):
    """Each kernel's registers, spills and shared memory from the build log,
    when this process built the library (a cached build has no log)."""
    import os
    path = os.path.join(os.path.dirname(lib), "build.log")
    if not os.path.exists(path):
        return
    with open(path) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("ptxas:", line.strip())


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


def float64_training_reference(model, bm, mg):
    """The first training step in float64 on the card with plain functions
    only: the dense Gram, torch.linalg.cholesky and cholesky_solve, and
    autograd over the plain Gram for the gradient. The LML's gradient is the
    gradient of the surrogate Σ K∘dK + Σ diag∘diag(dK) with the cotangent dK
    held fixed: for the probe-trace gradient (model.probes set)
    dK = A Bᵀ, A = ½[α, −U/R], B = [α, Z]; for the closed-form gradient
    dK = ½(ααᵀ − K⁻¹), K⁻¹ from torch.cholesky_inverse. The Gram part runs one
    channel-pair block at a time (pair_block_gram).

    Returns (LML, gradient of the loss −LML per trainable raw, the scale
    |½yᵀα| + Σ|log L_ii| of the LML's two terms)."""
    import torch
    named = [(path, p) for path, p in model.gp_parameters() if p.train]
    raws = [p.raw.detach().double().requires_grad_() for _, p in named]
    vals = {path: (p.transform.forward(r) if p.transform is not None else r)
            for (path, p), r in zip(named, raws)}
    allp = {path: p for path, p in model.gp_parameters()}

    def value(path):
        return vals[path] if path in vals else allp[path]().detach().double()

    kern = model.kernel
    w, mu, var, th, ph = (value("kernel." + k) for k in ("weight", "mean", "variance", "delay", "phase"))
    st3, st2 = bm.mosm_pair_stats(w, mu, var, th, ph, kern.twopi)
    c, x = kern._split(model.X.double())
    cl = c.long()
    n = x.shape[0]
    noise = value("likelihood.scale") ** 2
    noise_pt = noise[cl] if noise.ndim == 1 else noise.reshape(-1).expand(n)
    kdiag = torch.sum(w ** 2 * kern.twopi * torch.sqrt(torch.prod(var, dim=-1)), dim=-1)[cl]
    diag = noise_pt + model.jitter * torch.mean(kdiag + noise_pt)
    y = model.y.double()
    Z = None if model.probes is None else model.probes.double()
    with torch.no_grad():
        K = mg.mosm_gram_pairstats_plain(x, c, x, c, st3, st2)
        K.diagonal().add_(diag)
        L = torch.linalg.cholesky(K)
        del K
        AU = torch.cholesky_solve(y if Z is None else torch.cat([y, Z], dim=1), L, upper=False)
        alpha = AU[:, :1]
        logdet = torch.sum(torch.log(torch.diagonal(L)))
        quad = 0.5 * torch.sum(y * alpha)
        lml = float(-logdet - quad) - model.log_marginal_likelihood_constant
        scale = float(logdet.abs() + quad.abs())
        if Z is None:
            dK = torch.cholesky_inverse(L, upper=False).neg_().addr_(alpha[:, 0], alpha[:, 0]).mul_(0.5)
            block = lambda sa, sb: dK[sa, sb]
            ddiag = torch.diagonal(dK)
        else:
            A = 0.5 * torch.cat([alpha, -AU[:, 1:] / Z.shape[1]], dim=1)
            B = torch.cat([alpha, Z], dim=1)
            block = lambda sa, sb: A[sa] @ B[sb].T
            ddiag = torch.sum(A * B, dim=1)
        del L
    grads = list(torch.autograd.grad(torch.sum(diag * ddiag), raws,
                                     retain_graph=True, allow_unused=True))
    offs = np.concatenate([[0], np.cumsum(model._channel_counts)]).astype(int)
    O = len(model._channel_counts)
    for a in range(O):
        sa = slice(offs[a], offs[a + 1])
        for b in range(O):
            sb = slice(offs[b], offs[b + 1])
            Kab = pair_block_gram(x[sa], x[sb], st3[a, b], st2[a, b])
            s = torch.sum(Kab * block(sa, sb))
            for i, g in enumerate(torch.autograd.grad(s, raws, retain_graph=True, allow_unused=True)):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
            del Kab, s
    return lml, [-g for g in grads], scale


def pair_block_gram(xa, xb, s3, s2):
    """The MOSM Gram block between the points xa of one channel and xb of
    another from their pair's statistics s3 (Q, D, 3), s2 (Q, 2), in plain
    differentiable torch (mosm_gram_pairstats_plain's formula with the
    statistics as scalars: its per-element gathers would make autograd
    scatter 1.7e7-element index lists)."""
    import torch
    K = 0.0
    for q in range(s3.shape[0]):
        e = a = 0.0
        for d in range(s3.shape[1]):
            td = xa[:, d, None] - xb[None, :, d] + s3[q, d, 2]
            e = e + td * td * s3[q, d, 0]
            a = a + td * s3[q, d, 1]
        K = K + s2[q, 0] * torch.exp(-0.5 * e) * torch.cos(2.0 * np.pi * (a + s2[q, 1]))
    return K


def profile_step(model):
    """torch.profiler over one training step (after one unprofiled warm-up
    step): device time by kernel from the CUDA kernel events, and the
    device's busy and idle share of the profiled step's wall time. The raws
    are restored after."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    raws = model.trainable_raws()
    saved = [r.detach().clone() for r in raws]
    opt = torch.optim.Adam(raws, lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        model.loss().backward()
        opt.step()
        torch.cuda.synchronize()

    step()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        wall = 1e3 * (time.perf_counter() - t)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    busy = sum(ms for ms, _ in by_name.values())
    print("profile of one training step: wall %.2f ms (profiled), device busy %.2f ms, "
          "idle share %.3f" % (wall, busy, 1.0 - busy / wall))
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print("  %-70s %5d launches %9.3f ms" % (name[:70], count, ms))
    with torch.no_grad():
        for r, v in zip(raws, saved):
            r.copy_(v)
            r.grad = None


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
    """The median over `reps` calls of fn, each timed with CUDA events
    after `warmup` calls."""
    for _ in range(warmup):
        fn()
    return float(np.median([event_ms(fn) for _ in range(reps)]))


if __name__ == "__main__":
    sys.exit(main())
