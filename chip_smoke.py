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
  for an identical loss, then three steps;
- closed-form training: K-gram-bwd against its twin on the first step's
  dense cotangent (channel-sorted, and the same points permuted), then
  Exact(trace_probes=None) steps (K-gram, K-spanel, K-colwrite, K-solve, the
  inverse from the factor and K-gram-bwd), checked as above;
- the user API: mogptk_tpu_torch.MOSM on a DataSet of the same data trains
  three steps with the default Exact(), predicts and scores itself; a second
  MOSM initializes by BNSE;
- the iterative engine: K-matvec against its twin at N=16,384 (R = 1, 33
  and 1,024, channel-sorted and on permuted points); then the
  benchmarks/bignum_exact.py configuration (4 channels x 16,384 points,
  N=65,536, ExactIterative with 50 CG iterations, 16 probes and a rank-64
  preconditioner): K-matvec, K-lowrank-vjp and K-gram's pivot rows at the
  step's shapes against their twins, the first step's LML and gradient
  against a float64 execution of the same estimator with the same draws, a
  repeated step, three counted Adam steps; then the evaluation-grade
  readout's two halves against the dense float64 LML at N=16,384 and
  N=32,768, and iterative predict against Exact predict;
- sparse inference: K-gram-bwd's input half (dx1, dx2) against its twin on
  the first step's cotangents of bench.py's SVGP cell (Titsias, 256 random
  Halton inducing points per channel, M = 1,024, N = 16,384, the jitter
  ladder at 3 rungs): Kuf channel-sorted and with permuted rows, and Kuu;
  the repairs of the kernels' limits (K-lowrank-vjp at R = 65 and 129, the
  generic instances at Q = 5, D = 3, at O = 20 with the pair table in
  global memory and at D = 9, a float64 model on the card against the
  CPU); the Titsias's first ELBO and gradient (the inducing points'
  included) against a float64 execution on the card and the float32 plain
  twins, a repeated step, 20 counted Adam steps with the jitter rungs that
  fired, predict_y latency for 4,096 points, the same model through
  mogptk_tpu_torch.MOSM with the Titsias selector; then Snelson,
  SparseHensman, Hensman and OpperArchambeau at N = 4,096 (1,024 for the
  last two), each first step against float64 and three counted steps;
- the other multi-output families (uMOSM, CSM with Rq = 2, CONV, MOHSM
  under psd_safe, SM-LMC with Q = 2 and Rq = 2): K-fam-gram,
  K-fam-gram-bwd, K-fam-matvec and K-fam-lowrank-vjp against their plain
  twins at benchmarks/family_bench.py's configuration (2 channels x 2,048
  points, N = 4,096; R = 1, 17, 33 and 65; channel-sorted and permuted
  points; each repeat bit-identical), and for CSM and SM-LMC at bench.py's
  full width (N = 16,384); each family through gpr.Exact at N = 4,096
  (probe-trace and closed-form first steps against a float64 execution on
  the card and the float32 twins, three counted Adam steps each, predict_y
  of 1,024 points, family_bench.py's JSON keys); then at N = 16,384 the
  SM_LMC named model through the user API (BNSE, train, predict, error),
  gpr.Exact with the CSM kernel (both gradients, a 4,096-point request),
  one ExactIterative step of it at the bench budget against its float64
  execution, and the CSM, CONV and MOHSM named models (the dense
  formulations) three steps each at N = 4,096;
- the fused below-TRSM column loop and the block-lower syrk
  (gpr.config.blocked_cholesky_fused_trsm and pallas_syrk): K-sdiag and
  K-below-trsm at block column 16 of the bench factor, K-commit with and
  without zeroing the strip, K-syrk on W = L⁻¹ of the bench factor, each
  against its plain twin, the fused factor against the unfused one, and
  every block column of the fused factor held to K-sdiag's and
  K-below-trsm's summation bounds on its own left columns, which checks
  each row-tile instance of K-below-trsm where the path runs it
  (phase 19); then with both switches on the closed-form and the
  probe-trace steps at full width through gpr.train, each first step
  against the float64 reference of the switches-off step and its distance
  from that step, and three counted Adam steps (phase 20: 31 K-sdiag, 30
  K-below-trsm, 31 K-commit, one K-spanel and one K-colwrite a step, and
  one K-syrk a closed-form step).

Prints the card's name and power limit, per-kernel errors and times, per-
request and per-step times, then one JSON line {"kernels": [...]} and, last,
one JSON line {"ok": true, "device": {...}}. Exits nonzero, with no result
line, when there is no CUDA device, when run without the repository beside
it, or when any check fails. Times come from CUDA events (kernels, median of
10) and from the host clock between synchronizations (requests, steps).
Bounds use the H100 SXM's published peaks: 3.35 TB/s and 67 TFLOP/s FP32
outside the tensor cores.
"""
import contextlib
import json
import subprocess
import sys
import time

import numpy as np

N_PER_CHANNEL, CHANNELS, Q = 4096, 4, 2
PROBES, TRAIN_STEPS = 16, 3
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
        params = [p.detach() for p in model.kernel._params()]
        err, ms, pms, bnd = lowrank_vjp_check(bm, x, counts, params, model.kernel.twopi, st3, st2,
                                              A, Bm, "training shape")
        report["mosm_lowrank_vjp"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
                                          bound=bnd)
        del A, Bm, Xk
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

    # -- phase 9: K-matvec against its twin ------------------------------------
    t_iter = time.perf_counter()
    phase("phase 9: K-matvec against its twin (N=%d)" % n)
    check_matvec(gpr, X, Y, dev)
    torch.cuda.empty_cache()

    # -- phase 10: the iterative training path at full width -------------------
    phase("phase 10: iterative training path (benchmarks/bignum_exact.py, N=65,536)")
    report["mosm_matvec"], iter_launches = drive_iterative_training(gpr, dev, smi)
    torch.cuda.empty_cache()

    # -- phase 11: the readout and predict ---------------------------------------
    phase("phase 11: iterative readout and predict")
    check_readout_and_predict(gpr, xs, ys, X, Y, reqs["a"], dev)
    print("phases 9-11 (iterative engine) wall time: %.1f s" % (time.perf_counter() - t_iter))

    # -- phase 12: K-gram-bwd's input half against its plain twin ---------------
    t_sparse = time.perf_counter()
    phase("phase 12: K-gram-bwd's input half against its twin (bench Titsias, M=%d)"
          % (CHANNELS * SPARSE_M_PER_CHANNEL))
    gpr.set_seed(0)
    gpr.use_jitter_ladder(3)
    model = titsias_model(gpr, X, Y, dev)
    report["mosm_gram_bwd_inputs"] = check_gram_bwd_inputs(model, bm, mg)
    torch.cuda.empty_cache()

    # -- phase 13: the kernels' shape and dtype limits, repaired ----------------
    phase("phase 13: K-lowrank-vjp at R > 64, the generic instances, float64 on the card")
    check_repairs(gpr, bm, mg, X, Y, dev)
    torch.cuda.empty_cache()

    # -- phase 14: the sparse training path (bench.py's SVGP cell) --------------
    phase("phase 14: sparse training path (Titsias, bench.py's SVGP cell)")
    sparse_launches = drive_titsias(gpr, _build, model, reqs["b"], smi)
    del model
    torch.cuda.empty_cache()
    drive_user_api_titsias(xs, ys)
    torch.cuda.empty_cache()

    # -- phase 15: the other sparse and variational models ---------------------
    phase("phase 15: Snelson, SparseHensman, Hensman, OpperArchambeau")
    drive_other_sparse(gpr, _build, xs, ys, dev, smi)
    gpr.use_jitter_ladder(0)
    print("phases 12-15 (sparse inference) wall time: %.1f s" % (time.perf_counter() - t_sparse))
    torch.cuda.empty_cache()

    # -- phases 16-18: the other multi-output families -------------------------
    t_fam = time.perf_counter()
    fam_xs, fam_ys = drive_families(gpr, _build, dev, smi)
    phase("phase 18: the families at bench.py's full width (N=%d)" % n)
    fam_report, fam_launches = drive_families_full(gpr, _build, xs, ys, X, Y, reqs, fam_xs,
                                                   fam_ys, dev, smi)
    report.update(fam_report)
    print("phases 16-18 (the other families) wall time: %.1f s" % (time.perf_counter() - t_fam))

    # -- phases 19-20: the fused below-TRSM column loop and the block-lower syrk
    t_fused = time.perf_counter()
    phase("phase 19: K-sdiag, K-below-trsm, K-commit and K-syrk against their twins (N=%d)" % n)
    report.update(check_fused_kernels(gpr, bm, bc, bt, X, Y, dev))
    phase("phase 20: closed-form and probe-trace steps with fused_trsm and pallas_syrk on")
    fused_launches = drive_fused_path(gpr, bm, bc, bt, fs, mg, X, Y, dev, smi)
    print("phases 19-20 (fused below-TRSM loop, syrk) wall time: %.1f s"
          % (time.perf_counter() - t_fused))

    sources = {"cuda_gram": "mogptk_tpu_torch/csrc/mosm_gram.cu",
               "chol": "mogptk_tpu_torch/csrc/blocked_cholesky.cu",
               "fused": "mogptk_tpu_torch/csrc/fused_trsm.cu"}
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
        {"name": "mosm_matvec", "route": "cuda",
         "source": "mogptk_tpu_torch/csrc/mosm_matvec.cu",
         "replaces": "mogptk_tpu/ops/block_mosm.py:507; mogptk_tpu/ops/block_mosm.py:530; "
                     "mogptk_tpu/ops/fused.py:288",
         "path": "iterative train", "launches": iter_launches["mosm_matvec"]},
        {"name": "mosm_gram_bwd_inputs", "route": "cuda",
         "source": "mogptk_tpu_torch/csrc/mosm_gram_bwd.cu",
         "replaces": "mogptk_tpu/ops/pallas_mosm.py:274 (the input half of _bwd_kernel, :103-160)",
         "path": "sparse train", "launches": sparse_launches["mosm_gram_bwd_inputs"]},
        {"name": "family_gram", "route": "cuda", "source": "mogptk_tpu_torch/csrc/family_gram.cu",
         "replaces": "mogptk_tpu/ops/block_families.py:392; mogptk_tpu/ops/fused.py:386",
         "path": "family train", "launches": fam_launches["family_gram"]},
        {"name": "family_gram_bwd", "route": "cuda",
         "source": "mogptk_tpu_torch/csrc/family_gram_bwd.cu",
         "replaces": "mogptk_tpu/ops/block_families.py:431",
         "path": "family closed-form train", "launches": fam_launches["family_gram_bwd"]},
        {"name": "family_matvec", "route": "cuda",
         "source": "mogptk_tpu_torch/csrc/family_matvec.cu",
         "replaces": "mogptk_tpu/ops/block_families.py:504; mogptk_tpu/ops/block_families.py:525; "
                     "mogptk_tpu/ops/fused.py:288",
         "path": "family iterative train", "launches": fam_launches["family_matvec"]},
        {"name": "family_lowrank_vjp", "route": "cuda",
         "source": "mogptk_tpu_torch/csrc/family_lowrank_vjp.cu",
         "replaces": "mogptk_tpu/ops/block_families.py:590; mogptk_tpu/ops/fused.py:346",
         "path": "family train", "launches": fam_launches["family_lowrank_vjp"]},
        {"name": "s_diag", "route": "cuda", "source": sources["fused"],
         "replaces": "mogptk_tpu/ops/blocked_cholesky.py:414",
         "path": "closed-form train (fused_trsm)", "launches": fused_launches["s_diag"]},
        {"name": "below_trsm", "route": "cuda", "source": sources["fused"],
         "replaces": "mogptk_tpu/ops/blocked_cholesky.py:465; mogptk_tpu/ops/blocked_cholesky.py:504 "
                     "(the rows below the diagonal block)",
         "path": "closed-form train (fused_trsm)", "launches": fused_launches["below_trsm"]},
        {"name": "col_commit", "route": "cuda", "source": sources["fused"],
         "replaces": "mogptk_tpu/ops/blocked_cholesky.py:504 (the diagonal block); "
                     "mogptk_tpu/ops/blocked_cholesky.py:540",
         "path": "closed-form train (fused_trsm)", "launches": fused_launches["col_commit"]},
        {"name": "syrk_lower", "route": "cuda", "source": "mogptk_tpu_torch/csrc/syrk_lower.cu",
         "replaces": "mogptk_tpu/ops/blocked_trisolve.py:212",
         "path": "closed-form train (pallas_syrk)", "launches": fused_launches["syrk_lower"]},
    ]
    for k in kernels:
        if k["launches"] < 1:
            fail("%s was not launched on its main path" % k["name"])
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


SPARSE_M_PER_CHANNEL = 256   # bench.py's SVGP cell: M = 1,024 over 4 channels
SPARSE_STEPS = 20


class Counter:
    """A launch count kept in attribute `attr` of a kernel wrapper (the
    wrapper of K-gram-bwd counts its two instances apart), read and reset
    as `launches`."""

    def __init__(self, fn, attr):
        self.fn, self.attr = fn, attr

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, value):
        setattr(self.fn, self.attr, value)


def sparse_counters():
    from mogptk_tpu_torch.ops import linalg as la
    from mogptk_tpu_torch.ops import mosm_gram as mg
    return {"mosm_gram": mg.mosm_gram, "mosm_gram_bwd": mg.mosm_gram_bwd,
            "mosm_gram_bwd_inputs": Counter(mg.mosm_gram_bwd, "input_launches"),
            "jitter rungs": Counter(la.jittered_cholesky, "rungs")}


def titsias_model(gpr, X, Y, dev, Z=SPARSE_M_PER_CHANNEL, Z_init="random"):
    """bench.py's SVGP cell (bench.py:52-61, :155-173): Titsias on the bench
    model's kernel with Z=M // CHANNELS random (Halton) inducing points per
    channel and noise variance 0.1."""
    kernel = gpr.MultiOutputSpectralMixtureKernel(Q, output_dims=CHANNELS)
    set_bench_params(kernel)
    return gpr.Titsias(kernel, X, Y, Z=Z, Z_init=Z_init, variance=0.1, device=dev)


def gram_cotangents(model):
    """The Grams of the model's objective (in the order it forms them) and
    their cotangents at the current parameters: the Grams are made leaves
    for one loss().backward()."""
    import torch
    kernel = model.kernel
    K_orig = kernel.K
    grams = []

    def K(X1, X2=None):
        grams.append(K_orig(X1, X2).detach().requires_grad_())
        return grams[-1]

    kernel.K = K
    try:
        cot = torch.autograd.grad(model.loss(), grams)
    finally:
        del kernel.K
    return [g.detach() for g in grams], [g.contiguous() for g in cot]


def check_gram_bwd_inputs(model, bm, mg):
    """K-gram-bwd with the input half against its plain twin on the first
    Titsias step's cotangents of Kuf (M x N: the inducing points channel-
    sorted, and with their rows permuted) and of Kuu (M x M, x1 is x2),
    each output group (the parameter half, dx1, dx2) held at most twice as
    far from a float64 evaluation of the twin as the float32 twin, plus a
    floor of 1e-5 of its scale (float32 sums over up to 1.7e7 elements in
    two orders); a repeat is bit-identical. Times the path's calls (inputs
    1 for Kuf, 3 for Kuu) against the parameter half alone, the plain twin
    and the bound, with the channel counts given (the kernels' time) and
    read on the host (the wrapper as the sparse models call it). Returns
    the sorted Kuf call's report entry."""
    import torch
    dev, D, O = model.X.device, model.kernel.input_dims, model.kernel.output_dims
    _, cot = gram_cotangents(model)
    with torch.no_grad():
        cz, z = model.kernel._split(model.Z().detach())
        c, x = model.kernel._split(model.X)
        st3, st2 = bm.mosm_pair_stats(*[p.detach() for p in model.kernel._params()],
                                      model.kernel.twopi)
        perm = torch.as_tensor(np.random.RandomState(5).permutation(z.shape[0]), device=dev)
        M, N = z.shape[0], x.shape[0]
        cases = (("Kuf %dx%d channel-sorted" % (M, N), (z, cz, x, c, st3, st2, cot[0]), 1),
                 ("Kuf %dx%d rows permuted" % (M, N),
                  (z[perm], cz[perm], x, c, st3, st2, cot[0][perm].contiguous()), 1),
                 ("Kuu %dx%d (x1 is x2)" % (M, M), (z, cz, z, cz, st3, st2, cot[1]), 3))
        entry = None
        for label, args, inputs in cases:
            got = mg.mosm_gram_bwd(*args, inputs=3)
            again = mg.mosm_gram_bwd(*args, inputs=3)
            twin = mg.mosm_gram_bwd_plain(*args, inputs=3)
            a64 = [a.double() if a.is_floating_point() else a for a in args]
            ref = mg.mosm_gram_bwd_plain(*a64, inputs=3)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail("K-gram-bwd with inputs (%s): a repeated call differs" % label)
            parts = []
            for name, sl in (("pair cotangents", slice(0, 2)), ("dx1", slice(2, 3)),
                             ("dx2", slice(3, 4))):
                scale = max(float(r.abs().max()) for r in ref[sl])
                err_k = max(float((a.double() - r).abs().max()) for a, r in zip(got[sl], ref[sl]))
                err_t = max(float((a.double() - r).abs().max()) for a, r in zip(twin[sl], ref[sl]))
                tol = 2 * err_t + 1e-5 * scale
                parts.append("%s %.3e (twin %.3e, tol %.3e, scale %.3e)"
                             % (name, err_k, err_t, tol, scale))
                if not err_k <= tol:
                    fail("K-gram-bwd with inputs (%s): %s further from float64 than twice its "
                         "twin" % (label, name))
            err = max(float((a - b).abs().max()) for a, b in zip(got, twin))
            del got, again, twin, ref
            cnt = (mg.channel_counts(args[1], O), mg.channel_counts(args[3], O))
            ms = median_ms(lambda: mg.mosm_gram_bwd(*args, *cnt, inputs=inputs))
            ms0 = median_ms(lambda: mg.mosm_gram_bwd(*args, *cnt))
            wms = median_ms(lambda: mg.mosm_gram_bwd(*args, inputs=inputs))
            pms = median_ms(lambda: mg.mosm_gram_bwd_plain(*args, inputs=inputs), reps=3, warmup=1)
            n1, n2 = args[0].shape[0], args[2].shape[0]
            bnd = bound(4 * n1 * n2 + 4 * (n1 + n2) * (2 * D + 2), n1 * n2 * Q * (20 * D + 16))
            print("K-gram-bwd with inputs=%d, %s: vs float64 %s; vs twin %.3e; kernel %.3f ms "
                  "(parameter half alone %.3f ms; the wrapper reading the channel counts on the "
                  "host, as the sparse models' backward does, %.3f ms), plain %.3f ms, "
                  "bound %.3f ms (%s)" % ((inputs, label, "; ".join(parts), err, ms, ms0, wms, pms)
                                          + bnd))
            if entry is None:
                entry = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None, bound=bnd)
        # the user API's default of 10 inducing points per channel: the layout
        # pads each channel to 256 rows, so most of each tile is padding
        keep = torch.cat([torch.nonzero(cz == a)[:10, 0] for a in range(O)])
        z10, cz10, g10 = z[keep].contiguous(), cz[keep].contiguous(), cot[0][keep].contiguous()
        cnt = (mg.channel_counts(cz10, O), mg.channel_counts(c, O))
        ms = median_ms(lambda: mg.mosm_gram_bwd(z10, cz10, x, c, st3, st2, g10, *cnt, inputs=1))
        n1 = z10.shape[0]
        bnd = bound(4 * n1 * N + 4 * (n1 + N) * (2 * D + 2), n1 * N * Q * (20 * D + 16))
        print("K-gram-bwd with inputs=1, Kuf %dx%d (10 inducing points per channel, each "
              "padded to %d rows): kernel %.3f ms, bound %.4f ms (%s)"
              % ((n1, N, mg.BWD_TILE, ms) + bnd))
    return entry


def check_repairs(gpr, bm, mg, X, Y, dev):
    """The kernels' shape and dtype limits, repaired: K-lowrank-vjp at
    R = 65 and 129 at the training shape (two and three chunks of 64) and a
    probe-trace step with 64 probes through it; K-gram-bwd (with inputs) and
    K-lowrank-vjp in their generic instance at Q = 5, D = 3; K-gram and
    K-matvec in their generic instance at O = 20, Q = 4, D = 2 (the 51 KB
    pair table in global memory) and at D = 9; a float64 MOSM Exact model's
    step and predict on the card (the plain twins, no launch) against the
    CPU. Each kernel against float64 within twice its float32 twin plus a
    floor, as phases 4, 6 and 9 hold them."""
    import torch
    from mogptk_tpu_torch.ops import mosm_matvec as mv
    model = bench_model(gpr, X, Y, dev, 64)
    c, x = model.kernel._split(model.X)
    counts, twopi = model._channel_counts, model.kernel.twopi
    params = [p.detach() for p in model.kernel._params()]
    gen = torch.Generator(device=dev).manual_seed(11)
    with torch.no_grad():
        st3, st2 = bm.mosm_pair_stats(*params, twopi)
        for R in (65, 129):
            A, Bm = (torch.randn((x.shape[0], R), generator=gen, device=dev) for _ in range(2))
            lowrank_vjp_check(bm, x, counts, params, twopi, st3, st2, A, Bm,
                              "R=%d (%d chunks of <= 64)" % (R, -(-R // 64)), reps=3,
                              plain_reps=1, plain_warmup=0)
            del A, Bm
    before = bm.mosm_lowrank_vjp_sorted.launches
    loss = model.loss()
    loss.backward()
    torch.cuda.synchronize()
    grads = [r.grad for r in model.trainable_raws()]
    print("Exact(trace_probes=64) step (R = 65): loss %.6f, K-lowrank-vjp launches %d, "
          "gradient finite %s" % (float(loss.detach()), bm.mosm_lowrank_vjp_sorted.launches - before,
                                  all(bool(torch.isfinite(g).all()) for g in grads)))
    if bm.mosm_lowrank_vjp_sorted.launches - before != 1 or not all(
            bool(torch.isfinite(g).all()) for g in grads):
        fail("the probe-trace step with 64 probes did not go through K-lowrank-vjp")
    del model, loss, grads
    torch.cuda.empty_cache()

    rng = np.random.RandomState(12)

    def mosm(O, Qg, Dg):
        ps = [torch.as_tensor(p, dtype=torch.float32, device=dev) for p in (
            0.5 + rng.rand(O, Qg), 0.1 + rng.rand(O, Qg, Dg), 0.2 + rng.rand(O, Qg, Dg),
            0.1 * rng.randn(O, Qg, Dg), 0.1 * rng.randn(O, Qg))]
        return ps, float((2 * np.pi) ** (Dg / 2))

    with torch.no_grad():
        # the generic backward instances, Q = 5, D = 3, 3 channels
        sc = (1024, 512, 768)
        ns = sum(sc)
        xs3 = torch.as_tensor(np.sort(rng.rand(ns, 3) * 20, axis=0), dtype=torch.float32,
                              device=dev)
        cs3 = bm.channel_ids(sc, dev)
        ps, tp = mosm(3, 5, 3)
        s3, s2 = bm.mosm_pair_stats(*ps, tp)
        print("instances at O=3, Q=5, D=3: backward %s" % mg.kernel_instance("backward", 3, 5, 3))
        g = torch.randn((ns, ns), generator=gen, device=dev)
        args = (xs3, cs3, xs3, cs3, s3, s2, g)
        got = mg.mosm_gram_bwd(*args, sc, sc, inputs=3)
        twin = mg.mosm_gram_bwd_plain(*args, inputs=3)
        ref = mg.mosm_gram_bwd_plain(xs3.double(), cs3, xs3.double(), cs3, s3.double(),
                                     s2.double(), g.double(), inputs=3)
        scale = max(float(r.abs().max()) for r in ref)
        err_k = max(float((a.double() - r).abs().max()) for a, r in zip(got, ref))
        err_t = max(float((a.double() - r).abs().max()) for a, r in zip(twin, ref))
        ms = median_ms(lambda: mg.mosm_gram_bwd(*args, sc, sc, inputs=3), reps=3)
        print("K-gram-bwd generic (Q=5, D=3, N=%d, inputs=3): vs float64 %.3e (twin %.3e, tol "
              "%.3e), kernel %.3f ms" % (ns, err_k, err_t, 2 * err_t + 1e-5 * scale, ms))
        if not err_k <= 2 * err_t + 1e-5 * scale:
            fail("K-gram-bwd's generic instance is further from float64 than twice its twin")
        del g, got, twin, ref
        A, Bm = (torch.randn((ns, 17), generator=gen, device=dev) for _ in range(2))
        lowrank_vjp_check(bm, xs3, sc, ps, tp, s3, s2, A, Bm, "generic (Q=5, D=3)", reps=3,
                          plain_reps=1, plain_warmup=0)
        # the generic forward instances
        for O, Qg, Dg in ((20, 4, 2), (2, 1, 9)):
            n = 4096
            xg = torch.as_tensor(rng.rand(n, Dg) * 10, dtype=torch.float32, device=dev)
            cg = torch.as_tensor(rng.randint(0, O, n), dtype=torch.int32, device=dev)
            ps, tp = mosm(O, Qg, Dg)
            s3, s2 = bm.mosm_pair_stats(*ps, tp)
            table = 4 * O * O * (3 * Qg * Dg + 2 * Qg)
            K = mg.mosm_gram(xg, cg, xg, cg, s3, s2)
            Kp = mg.mosm_gram_pairstats_plain(xg, cg, xg, cg, s3, s2)
            err, kmax = float((K - Kp).abs().max()), float(Kp.abs().max())
            ms = median_ms(lambda: mg.mosm_gram(xg, cg, xg, cg, s3, s2), reps=3)
            print("K-gram O=%d Q=%d D=%d (pair table %d bytes, %s instance): max_abs_err %.3e "
                  "(tol %.3e), kernel %.3f ms" % (O, Qg, Dg, table,
                                                  mg.kernel_instance("forward", O, Qg, Dg), err,
                                                  2e-4 * kmax, ms))
            if not err <= 2e-4 * kmax:
                fail("K-gram's generic instance disagrees with its plain twin")
            del K, Kp
            V = torch.randn((n, 33), generator=gen, device=dev)
            matvec_check(mv, mg, xg, cg, s3, s2, V, "generic O=%d Q=%d D=%d" % (O, Qg, Dg), reps=3)

    # float64 on the card: the plain twins on the card against the CPU
    saved = gpr.config._dtype
    gpr.use_double_precision()
    try:
        xs_, ys_ = make_data()
        xs_, ys_ = [a[::16] for a in xs_], [a[::16] for a in ys_]
        out = []
        counts_before = (mg.mosm_gram.launches, mg.mosm_gram_bwd.launches)
        for device in ("cpu", dev):
            _, Xd, Yd = gpr.merge_data(xs_, ys_, device=device)
            m = bench_model(gpr, Xd, Yd, device, None)
            loss = m.loss()
            loss.backward()
            mu, var = m.predict_f(Xd[::5])
            out.append([loss.detach(), mu, var] + [r.grad for r in m.trainable_raws()])
        d = max(float((b.cpu() - a).abs().max() / max(float(a.abs().max()), 1e-300))
                for a, b in zip(*out))
        launched = (mg.mosm_gram.launches, mg.mosm_gram_bwd.launches) != counts_before
        print("float64 Exact (N=%d) on the card vs the CPU: loss, predict and gradient within "
              "%.3e relative (tol 1e-9), kernel launches %s" % (Xd.shape[0], d, launched))
        if d > 1e-9 or launched:
            fail("float64 on the card disagrees with the CPU or launched a float32 kernel")
    finally:
        gpr.config._dtype = saved


@contextlib.contextmanager
def plain_twins(_build):
    """Inside, every kernel wrapper runs its plain twin on the card (the
    float32 twin execution that a check holds the kernels' execution to)."""
    saved = _build.runs_plain
    _build.runs_plain = lambda t: True
    try:
        yield
    finally:
        _build.runs_plain = saved


def step_outputs(model):
    """[loss, every trainable raw's gradient] of one loss().backward()."""
    raws = model.trainable_raws()
    for r in raws:
        r.grad = None
    loss = model.loss()
    loss.backward()
    out = [loss.detach()] + [r.grad.detach().clone() for r in raws]
    for r in raws:
        r.grad = None
    return out


@contextlib.contextmanager
def family_twins(_build):
    """Inside, the family kernels' wrappers (ops/block_families) run their
    plain twins on the card; every other kernel launches as before."""
    from mogptk_tpu_torch.ops import block_families as bf

    class Plain:
        runs_plain = staticmethod(lambda t: True)

        def __getattr__(self, name):
            return getattr(_build, name)

    bf._build = Plain()
    try:
        yield
    finally:
        bf._build = _build


def three_ways(gpr, _build, model, rebuild, fn, twins=plain_twins):
    """fn(model) through the kernels, through the float32 plain twins on the
    card (twins(_build): every kernel's, or with family_twins the family
    kernels' only), and through a float64 copy (rebuild() under float64,
    then the model's raws and relative jitter) on the card's float64 route;
    three lists of float64 tensors, and the jitter rungs each execution
    fired."""
    from mogptk_tpu_torch.ops import linalg as la
    rungs, outs = [], []
    for how in ("kernels", "twins", "float64"):
        r0 = la.jittered_cholesky.rungs
        if how == "kernels":
            out = fn(model)
        elif how == "twins":
            with twins(_build):
                out = fn(model)
        else:
            raws = [r.detach().double().cpu().numpy() for r in model.raw_state()]
            saved = gpr.config._dtype
            gpr.use_double_precision()
            try:
                m64 = rebuild()
                gpr.load_raw_state(m64, raws)
                m64.jitter = model.jitter      # float64's own floor is lower
                out = fn(m64)
            finally:
                gpr.config._dtype = saved
            del m64
        rungs.append(la.jittered_cholesky.rungs - r0)
        outs.append([t.double() for t in out])
    return outs, rungs


def held(label, what, got, twin, ref, floor):
    """max |got − ref| <= 2·max |twin − ref| + floor·max |ref| over a group
    of tensors; prints the reading and fails beyond it. Returns the two
    distances and the limit."""
    scale = max(float(r.abs().max()) for r in ref)
    d_k = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    d_t = max(float((t - r).abs().max()) for t, r in zip(twin, ref))
    tol = 2 * d_t + floor * scale
    print("%s %s: vs float64 %.4e (float32 twins %.4e, tol %.4e, scale %.4e)"
          % (label, what, d_k, d_t, tol, scale))
    if not d_k <= tol:
        fail("%s: %s is further from float64 than twice the float32 twins" % (label, what))
    return d_k, d_t, tol


def check_sparse_first_step(gpr, _build, model, rebuild, label):
    """The model's first step (loss and every raw's gradient, the inducing
    points' on their own too) through the kernels, held against a float64
    execution on the card at most twice as far off as the float32 plain
    twins, plus a floor of 1e-5 of the scale (a float32 sum of N = 16,384
    terms in another order: √N·u ≈ 8e-6); then once more for a
    bit-identical loss and gradient. Where the jitter ladder fires in
    float32 (a factor too ill-conditioned for float32 at the model's
    jitter), the three executions are held at the jitter it settled on, so
    that all three factor the same matrices; the model's jitter is restored
    after. Returns the first loss."""
    import torch
    from mogptk_tpu_torch.ops import linalg as la
    r0 = la.jittered_cholesky.rungs
    first = step_outputs(model)
    fired = la.jittered_cholesky.rungs - r0
    jitter = model.jitter
    if fired:
        model.jitter = jitter * 10.0 ** fired
        print("%s: the jitter ladder fired %d rung(s) in float32 at relative jitter %.1e; the "
              "first step is held at %.1e, where it settled" % (label, fired, jitter,
                                                                model.jitter))
    try:
        (got, twin, ref), rungs = three_ways(gpr, _build, model, rebuild, step_outputs)
    finally:
        model.jitter = jitter
    print("%s first step: loss %.6f (float64 %.6f), jitter rungs fired (kernels, twins, "
          "float64) %s" % (label, float(got[0]), float(ref[0]), rungs))
    if any(rungs) or not all(torch.equal(a.double(), b) for a, b in zip(first, got)):
        fail("%s: the executions do not factor the matrices the ladder settled on" % label)
    held(label, "loss", got[:1], twin[:1], ref[:1], 1e-5)
    held(label, "gradient", got[1:], twin[1:], ref[1:], 1e-5)
    if getattr(model, "Z", None) is not None and model.Z.train:
        train = [p for _, p in model.gp_parameters() if p.train]
        k = 1 + next(i for i, p in enumerate(train) if p is model.Z)
        held(label, "inducing points' gradient", got[k:k + 1], twin[k:k + 1], ref[k:k + 1], 1e-5)
        if float(got[k][:, 0].abs().max()) != 0.0:
            fail("%s: the inducing points' channel column has a gradient" % label)
    again = step_outputs(model)
    if not all(torch.equal(a, b) for a, b in zip(again, first)):
        fail("%s: a repeated first step gave another loss or gradient" % label)
    print("%s repeated first step: identical loss %.9g and gradients" % (label, float(first[0])))
    return float(first[0])


def drive_titsias(gpr, _build, model, Xq, smi):
    """Phase 14: the bench Titsias's first step against float64, an optional
    profile, SPARSE_STEPS counted Adam steps (K-gram twice a step, K-gram-bwd
    with the input half twice, the parameter-only K-gram-bwd never; the
    jitter rungs that fired), predict_y latency at Xq against a float64
    execution, and the channel column of Z left as it was. Returns the
    training run's counts."""
    import torch
    dev = model.X.device

    def rebuild():
        return titsias_model(gpr, model.X.double(), model.y.double(), dev,
                             Z=model.Z().detach().double(), Z_init="grid")

    loss1 = check_sparse_first_step(gpr, _build, model, rebuild, "Titsias")
    if "--profile" in sys.argv[1:]:
        profile_step(model)
    Z0 = model.Z.raw.detach().clone()
    want = {"mosm_gram": (2, 2), "mosm_gram_bwd_inputs": (2, 2), "mosm_gram_bwd": (0, 0)}
    launches = train_and_count(gpr, model, sparse_counters(), want, loss1, "Titsias", smi,
                               steps=SPARSE_STEPS)
    if not torch.equal(model.Z.raw[:, 0], Z0[:, 0]):
        fail("training moved the inducing points' channel column")
    print("Titsias: the inducing points moved by at most %.3e in x"
          % float((model.Z.raw.detach()[:, 1:] - Z0[:, 1:]).abs().max()))

    M = Xq.shape[0]
    model.predict_y(Xq, sigma=2)        # warm-up
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mu, lo, up = model.predict_y(Xq, sigma=2)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    for out in (mu, lo, up):
        if out.shape != (M, 1) or not bool(torch.isfinite(out).all()):
            fail("Titsias predict_y: non-finite or misshapen answer")
    if not bool((lo < mu).all() and (mu < up).all()):
        fail("Titsias predict_y: bands do not bracket the mean")
    print("Titsias predict_y for %d points: median %.2f ms, p90 %.2f ms over 10 requests (%s)"
          % (M, float(np.median(times)), float(np.percentile(times, 90)),
             smi.stdout.strip().splitlines()[0]))
    with torch.no_grad():
        (got, twin, ref), _ = three_ways(gpr, _build, model, rebuild,
                                         lambda m: list(m.predict_f(Xq)))
    held("Titsias predict_f (%d points, after training)" % M, "mean", got[:1], twin[:1],
         ref[:1], 1e-5)
    held("Titsias predict_f (%d points, after training)" % M, "variance", got[1:], twin[1:],
         ref[1:], 1e-5)
    return launches


def drive_user_api_titsias(xs, ys):
    """The same model through the user API: mogptk.MOSM with the Titsias
    selector (256 random inducing points per channel) trains three steps
    through K-gram-bwd's input half, predicts and scores itself."""
    import torch
    import mogptk_tpu_torch as mogptk
    counters = sparse_counters()
    ds = mogptk.DataSet([xc[:, 0] for xc in xs], [yc[:, 0] for yc in ys])
    api = mogptk.MOSM(ds, Q=Q, inference=mogptk.Titsias(inducing_points=SPARSE_M_PER_CHANNEL,
                                                          init_inducing_points="random"))
    if type(api.gpr).__name__ != "Titsias" or api.gpr.Z.raw.device.type != "cuda":
        fail("MOSM with the Titsias selector did not build a Titsias on the card")
    set_bench_params(api.gpr.kernel)
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses, _ = api.train(method="Adam", lr=0.01, iters=TRAIN_STEPS)
    torch.cuda.synchronize()
    raised = {k: f.launches for k, f in counters.items()}
    print("MOSM(inference=Titsias(%d, 'random')).train(Adam, iters=%d): %.2f s, losses %s, "
          "launches %s" % (SPARSE_M_PER_CHANNEL, TRAIN_STEPS, time.perf_counter() - t,
                           np.round(losses, 4).tolist(), raised))
    if not np.all(np.isfinite(losses)) or raised["mosm_gram_bwd_inputs"] != 2 * TRAIN_STEPS:
        fail("MOSM with the Titsias selector did not train through K-gram-bwd's input half")
    Xp, Mu, Lo, Up = api.predict()
    for j in range(CHANNELS):
        if Mu[j].shape != (N_PER_CHANNEL,) or not np.all(np.isfinite(Mu[j])):
            fail("MOSM(Titsias).predict: channel %d is non-finite or misshapen" % j)
        if not (np.all(Lo[j] < Mu[j]) and np.all(Mu[j] < Up[j])):
            fail("MOSM(Titsias).predict: channel %d's bands do not bracket the mean" % j)
    mae = api.error("MAE")
    yall = np.concatenate(ys)
    print("MOSM(Titsias).error('MAE') = %.6f (the data's own spread %.6f)"
          % (mae, np.mean(np.abs(yall - yall.mean()))))
    if not (np.isfinite(mae) and mae < np.mean(np.abs(yall - yall.mean()))):
        fail("MOSM(Titsias).error('MAE') = %r is not a fit" % mae)


def drive_other_sparse(gpr, _build, xs, ys, dev, smi):
    """Phase 15: Snelson and SparseHensman at N = 4,096 (every fourth bench
    point, 64 grid inducing points per channel), Hensman and
    OpperArchambeau at N = 1,024 (every sixteenth; their variational
    parameters are one per point): each first step against a float64
    execution and the float32 twins, then TRAIN_STEPS counted Adam steps."""
    import torch

    def data(every):
        _, Xd, Yd = gpr.merge_data([a[::every] for a in xs], [a[::every] for a in ys], device=dev)
        return Xd, Yd

    def kernel():
        k = gpr.MultiOutputSpectralMixtureKernel(Q, output_dims=CHANNELS)
        set_bench_params(k)
        return k

    X4, Y4 = data(4)
    X16, Y16 = data(16)
    inducing = {"mosm_gram": (2, 2), "mosm_gram_bwd_inputs": (2, 2), "mosm_gram_bwd": (0, 0)}
    dense = {"mosm_gram": (1, 1), "mosm_gram_bwd_inputs": (0, 0), "mosm_gram_bwd": (1, 1)}
    cases = (
        ("Snelson", X4, Y4, inducing,
         lambda X_, Y_, Z: gpr.Snelson(kernel(), X_, Y_, Z=Z, variance=0.1, device=dev)),
        ("SparseHensman", X4, Y4, inducing,
         lambda X_, Y_, Z: gpr.SparseHensman(kernel(), X_, Y_, Z=Z, device=dev)),
        ("Hensman", X16, Y16, dense, lambda X_, Y_, Z: gpr.Hensman(kernel(), X_, Y_, device=dev)),
        ("OpperArchambeau", X16, Y16, dense,
         lambda X_, Y_, Z: gpr.OpperArchambeau(kernel(), X_, Y_, device=dev)))
    for label, Xd, Yd, want, make in cases:
        model = make(Xd, Yd, 64)
        if hasattr(model, "q_sqrt"):      # q(u) away from p(u), so Z's gradient is not zero
            n = model.q_mu.shape[0]
            rng = np.random.RandomState(8)
            model.q_mu.assign(0.3 * rng.randn(n, 1))
            model.q_sqrt.assign(np.eye(n) + 0.01 * np.tril(rng.randn(n, n), -1))

        def rebuild(model=model, make=make):
            Z = getattr(model, "Z", None)
            Z = Z().detach().double() if Z is not None and Z.train else None
            return make(model.X.double(), model.y.double(), Z)

        loss1 = check_sparse_first_step(gpr, _build, model, rebuild,
                                        "%s (N=%d)" % (label, Xd.shape[0]))
        train_and_count(gpr, model, sparse_counters(), want, loss1, label, smi)
        del model
        torch.cuda.empty_cache()


ITER_N_PER_CHANNEL = 16384
ITER_SETTINGS = dict(variance=0.1, max_cg_iters=50, cg_tol=1e-4, num_probes=16,
                     lanczos_iters=24, precond_rank=64)
# a budget under which every CG column of the first step converges (checked
# and printed), for the float64 comparison of the whole step
ITER_RANK_C, ITER_CG_C = 256, 150


def make_bignum_data():
    """benchmarks/bignum_exact.py:32-44: 4 channels x 16,384 points, and the
    kernel parameters it sets from the same generator."""
    rng = np.random.RandomState(0)
    xs, ys = [], []
    for j in range(CHANNELS):
        x = np.sort(rng.uniform(0.0, 100.0, ITER_N_PER_CHANNEL)).reshape(-1, 1)
        y = (np.sin(0.5 * x[:, 0] + j) + 0.1 * rng.randn(ITER_N_PER_CHANNEL)).reshape(-1, 1)
        xs.append(x)
        ys.append(y)
    return xs, ys, 0.05 + 0.3 * rng.rand(CHANNELS, Q, 1), 0.2 + 0.3 * rng.rand(CHANNELS, Q, 1)


def matvec_scale(mg, x, c, st3, st2, V, rows=2048):
    """max over entries of |K|·|V| (float32 row blocks of the plain Gram):
    the size of the terms each entry of K·V sums."""
    import torch
    out = 0.0
    Va = V.abs()
    for r0 in range(0, x.shape[0], rows):
        Kb = mg.mosm_gram_pairstats_plain(x[r0:r0 + rows], c[r0:r0 + rows], x, c, st3, st2)
        out = max(out, float((Kb.abs() @ Va).max()))
        del Kb
    return out


def matvec_check(mv, mg, x, c, st3, st2, V, label, reps=10):
    """K-matvec against its float32 twin and a float64 twin on the same
    inputs. Tolerance: at most twice the float32 twin's error against float64
    plus 1e-6 of max |K|·|V| (summation order alone). Returns (max |kernel −
    twin|, kernel ms, twin ms)."""
    import torch
    got = mv.mosm_matvec(x, c, st3, st2, V)
    again = mv.mosm_matvec(x, c, st3, st2, V)
    twin = mv.mosm_matvec_plain(x, c, st3, st2, V)
    ref = mv.mosm_matvec_plain(x.double(), c, st3.double(), st2.double(), V.double())
    torch.cuda.synchronize()
    err_k = float((got.double() - ref).abs().max())
    err_t = float((twin.double() - ref).abs().max())
    err = float((got - twin).abs().max())
    scale = matvec_scale(mg, x, c, st3, st2, V)
    tol = 2 * err_t + 1e-6 * scale
    ms = median_ms(lambda: mv.mosm_matvec(x, c, st3, st2, V), reps=reps)
    pms = median_ms(lambda: mv.mosm_matvec_plain(x, c, st3, st2, V), reps=3, warmup=1)
    n, R = V.shape
    bnd = bound(4 * (n * (x.shape[1] + 1) + 2 * n * R), gram_ops(n * n, x.shape[1]) + 2 * n * n * R)
    print("K-matvec %s N=%d R=%d: vs float64 %.3e (twin %.3e, tol %.3e, max|K||V| %.3e), vs twin "
          "%.3e, kernel %.3f ms, plain %.3f ms, bound %.3f ms (%s)"
          % ((label, n, R, err_k, err_t, tol, scale, err, ms, pms) + bnd))
    if not err_k <= tol:
        fail("K-matvec (%s, R=%d) is further from float64 than twice its plain twin" % (label, R))
    if not torch.equal(got, again):
        fail("K-matvec (%s, R=%d): a repeated call differs" % (label, R))
    return err, ms, pms, bnd


def lowrank_vjp_check(bm, x, counts, params, twopi, st3, st2, A, Bm, label, reps=10,
                      plain_reps=10, plain_warmup=2):
    """K-lowrank-vjp against its float32 twin and a float64 twin on the same
    inputs, compared as parameter cotangents (pair_stats_vjp, the chain the
    training paths apply). Tolerance: float32 sums over the N² elements in
    two orders, so at most twice the float32 twin's error against float64,
    plus a floor of 1e-5 of the cotangents' scale. Returns (max |kernel −
    twin|, kernel ms, twin ms, bound)."""
    got = bm.pair_stats_vjp(params, twopi, *bm.mosm_lowrank_vjp_sorted(x, counts, st3, st2, A, Bm))
    twin = bm.pair_stats_vjp(params, twopi, *bm.mosm_lowrank_vjp_plain(x, counts, st3, st2, A, Bm))
    p64 = [p.double() for p in params]
    ref = bm.pair_stats_vjp(p64, twopi, *bm.mosm_lowrank_vjp_plain(
        x.double(), counts, *bm.mosm_pair_stats(*p64, twopi), A.double(), Bm.double()))
    scale = max(float(r.abs().max()) for r in ref)
    err_k = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
    err_t = max(float((g.double() - r).abs().max()) for g, r in zip(twin, ref))
    err = max(float((g - t).abs().max()) for g, t in zip(got, twin))
    tol = 2 * err_t + 1e-5 * scale
    del got, twin, ref
    ms = median_ms(lambda: bm.mosm_lowrank_vjp_sorted(x, counts, st3, st2, A, Bm), reps=reps)
    pms = median_ms(lambda: bm.mosm_lowrank_vjp_plain(x, counts, st3, st2, A, Bm),
                    reps=plain_reps, warmup=plain_warmup)
    idx, _ = bm._pair_layout(tuple(counts), bm.BWD_TILE)
    sym = int((idx[:, 0] != idx[:, 1]).sum())
    n, D, R1, tile = x.shape[0], x.shape[1], A.shape[1], bm.BWD_TILE ** 2
    ops = (tile * R1 * (4 * sym + 2 * (idx.shape[0] - sym))
           + tile * idx.shape[0] * Q * (18 * D + 16))
    bnd = bound(4 * n * (2 * R1 + D), ops)
    print("K-lowrank-vjp %s, %d tiles of %d^2 (R=%d): parameter cotangents vs float64 %.3e "
          "(twin %.3e, tol %.3e, scale %.3e), vs twin %.3e, kernel %.3f ms, plain %.3f ms, "
          "bound %.3f ms (%s)"
          % ((label, idx.shape[0], bm.BWD_TILE, R1, err_k, err_t, tol, scale, err, ms, pms) + bnd))
    if not err_k <= tol:
        fail("K-lowrank-vjp (%s) is further from float64 than twice its plain twin" % label)
    return err, ms, pms, bnd


def check_matvec(gpr, X, Y, dev):
    """Phase 9: K-matvec at the bench model's N=16,384 with the bench
    parameters, R = 1 (predict's and the readout's solves), 33 (the training
    CG) and 1,024 (predict's column blocks); channel-sorted, and the same
    points permuted (unsorted channel IDs, the JAX package's C3 case)."""
    import torch
    from mogptk_tpu_torch.ops import block_mosm as bm, mosm_gram as mg, mosm_matvec as mv
    kernel = gpr.MultiOutputSpectralMixtureKernel(Q, output_dims=CHANNELS)
    set_bench_params(kernel)
    kernel.to(dev)
    with torch.no_grad():
        c, x = kernel._split(X)
        st3, st2 = bm.mosm_pair_stats(*kernel._params(), kernel.twopi)
        n = x.shape[0]
        perm = torch.as_tensor(np.random.RandomState(5).permutation(n), device=dev)
        xp, cp = x[perm].contiguous(), c[perm].contiguous()
        rng = np.random.RandomState(6)
        for R in (1, 33, 1024):
            V = torch.as_tensor(rng.randn(n, R), dtype=torch.float32, device=dev)
            for label, xx, cc, VV in (("channel-sorted", x, c, V),
                                      ("permuted", xp, cp, V[perm].contiguous())):
                matvec_check(mv, mg, xx, cc, st3, st2, VV, label, reps=5)
                if R == 33:
                    lms = median_ms(lambda: torch.matmul(mg.mosm_gram(xx, cc, xx, cc, st3, st2), VV),
                                    reps=5)
                    print("library (%s): K-gram %dx%d + torch.matmul (R=%d) %.3f ms"
                          % (label, n, n, R, lms))
            del V


def bignum_model(gpr, dev):
    xs, ys, mean, var = make_bignum_data()
    _, X, Y = gpr.merge_data(xs, ys, device=dev)
    kernel = gpr.MultiOutputSpectralMixtureKernel(Q, output_dims=CHANNELS)
    kernel.mean.assign(mean)
    kernel.variance.assign(var)
    return gpr.ExactIterative(kernel, X, Y, device=dev, **ITER_SETTINGS)


def drive_iterative_training(gpr, dev, smi):
    """Phase 10 at N=65,536: K-matvec at the training CG's shape against its
    twin and beside K-gram + torch.matmul on the materialized Gram; the
    first step against a float64 execution of the same estimator; a repeated
    step; then three Adam steps of gpr.train with every count set to 0
    first. Returns (K-matvec's report entry, the counts of the run)."""
    import torch
    from mogptk_tpu_torch.ops import block_mosm as bm, mosm_gram as mg, mosm_matvec as mv
    from mogptk_tpu_torch.ops import blocked_cholesky as bc, fused_solve as fs
    model = bignum_model(gpr, dev)
    lay = model._layout
    n = model.X.shape[0]
    R = 1 + 2 * model.num_probes
    with torch.no_grad():
        st3, st2 = bm.mosm_pair_stats(*model.kernel._params(), model.kernel.twopi)
        V = torch.as_tensor(np.random.RandomState(8).randn(n, R), dtype=torch.float32, device=dev)
        err, ms, pms, bnd = matvec_check(mv, mg, lay["x"], lay["c"], st3, st2, V,
                                         "training shape", reps=5)

        def library():
            K = mg.mosm_gram(lay["x"], lay["c"], lay["x"], lay["c"], st3, st2)
            out = torch.matmul(K, V)
            del K
            return out

        lms = median_ms(library, reps=3, warmup=1)
        print("library: K-gram %dx%d + torch.matmul (R=%d) %.3f ms" % (n, n, R, lms))
        entry = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms, bound=bnd)
        # K-lowrank-vjp at this shape (the step's backward: A, B of 1 + P columns)
        Am, Bm = V[:, :1 + model.num_probes].contiguous(), V[:, -1 - model.num_probes:].contiguous()
        params = [p.detach() for p in model.kernel._params()]
        lowrank_vjp_check(bm, lay["x"], lay["counts"], params, model.kernel.twopi, st3, st2, Am, Bm,
                          "iterative step's shape", reps=5, plain_reps=3, plain_warmup=1)
        # the preconditioner's pivot rows: K-gram of one row against all N
        # points, at the first pivot, in the caller's order and on permuted
        # points (unsorted channel IDs)
        perm = torch.as_tensor(np.random.RandomState(9).permutation(n), device=dev)
        for label, xx, cc in (("caller's order", lay["x_orig"], lay["c_orig"]),
                              ("permuted", lay["x_orig"][perm], lay["c_orig"][perm])):
            i1 = torch.argmax(model.kernel.K_mo_diag(cc, xx)).reshape(1)
            args = (xx.index_select(0, i1), cc.index_select(0, i1), xx, cc, st3, st2)
            got = mg.mosm_gram(*args)
            twin = mg.mosm_gram_pairstats_plain(*args)
            ref = mg.mosm_gram_pairstats_plain(args[0].double(), args[1], xx.double(), cc,
                                               st3.double(), st2.double())
            err = float((got - twin).abs().max())
            tol = 2e-4 * float(ref.abs().max())   # as phase 2's K-gram
            print("K-gram pivot row 1x%d (%s): vs twin %.3e (tol %.3e), vs float64 %.3e (twin "
                  "%.3e), max|K| %.4f"
                  % (n, label, err, tol, float((got.double() - ref).abs().max()),
                     float((twin.double() - ref).abs().max()), float(ref.abs().max())))
            if not err <= tol:
                fail("K-gram disagrees with its plain twin on a pivot row (%s)" % label)
        del V, Am, Bm
    torch.cuda.empty_cache()

    converged = gpr.ExactIterative(model.kernel, model.X, model.y, device=dev,
                                   **dict(ITER_SETTINGS, precond_rank=ITER_RANK_C,
                                          max_cg_iters=ITER_CG_C))
    loss1 = check_first_iterative_steps([model, converged], bm, mg, mv)
    del converged
    torch.cuda.empty_cache()
    if "--profile" in sys.argv[1:]:
        profile_step(model)
    counters = {"mosm_matvec": mv.mosm_matvec, "mosm_lowrank_vjp": bm.mosm_lowrank_vjp_sorted,
                "mosm_gram": mg.mosm_gram, "mosm_gram_bwd": mg.mosm_gram_bwd,
                "mosm_gram_lower": bm.mosm_gram_sorted_lower, "s_panel": bc.s_panel,
                "col_write": bc.col_write, "fused_cho_solve": fs.fused_cho_solve}
    want = {"mosm_matvec": (model.max_cg_iters, model.max_cg_iters),
            "mosm_lowrank_vjp": (1, 1), "mosm_gram": (model.precond_rank, model.precond_rank),
            "mosm_gram_bwd": (0, 0), "mosm_gram_lower": (0, 0), "s_panel": (0, 0),
            "col_write": (0, 0), "fused_cho_solve": (0, 0)}
    launches = train_and_count(gpr, model, counters, want, loss1, "iterative", smi)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print("iterative training: peak device memory %.2f GiB" % peak)
    return entry, launches


def first_step_parts(model, it):
    """One forward of the model's training-path estimate through the
    kernels, with its parts (gpr.iterative.lml_iter_value)."""
    import torch
    lay = model._layout
    with torch.no_grad():
        pack, kdiag = model._pack()
        pack = tuple(t.detach() for t in pack)
        noise = model._noise_diag().detach()
        matvec = it.make_matvec(model.family, lay["x"], lay["c"], pack, lay.sort(noise))
        L, s2 = model._factor(noise, pack, kdiag, model.precond_rank)
        val, alpha, _, parts = it.lml_iter_value(matvec, L, s2, lay.sort(model.y), model._Z,
                                                 model._u0, model._u1, model.max_cg_iters,
                                                 model.cg_tol)
    return float(val), float(-0.5 * torch.sum(lay.sort(model.y) * alpha)), parts


def describe(parts):
    res, act = parts["res"].cpu().numpy(), parts["active"].cpu().numpy()
    P = (len(res) - 1) // 2
    return ("log det P %.3f, quadrature %.3f (probe SE %.3f), CG relative residuals y %.2e, "
            "probes max %.2e, P-probes max %.2e; active iterations y %d, probes %d-%d, "
            "P-probes %d-%d" % (float(parts["logdetP"]), float(parts["quads"].mean()),
                                float(parts["quads"].std() / np.sqrt(P)), res[0],
                                res[1:1 + P].max(), res[1 + P:].max(), act[0], act[1:1 + P].min(),
                                act[1:1 + P].max(), act[1 + P:].min(), act[1 + P:].max()))


def check_first_iterative_steps(models, bm, mg, mv):
    """The first iterative step (loss and every raw's gradient) of each
    model against a float64 execution of the same estimator with the same
    draws, then the bench model's step once more for a bit-identical loss
    and gradient. models[0] is the bench configuration, models[1] the same
    data, parameters and draws with a budget under which every CG column
    converges. Returns the bench model's first loss.

    Tolerances. The log-det half, log det P + the probes' mean quadrature,
    within 3 standard errors of that mean (SE from the float64 execution's
    per-probe quadratures): the two executions share the probes, but their
    Lanczos tridiagonals end at different iterations (the float32 CG's
    columns converge later), so they differ by the estimator's own
    resolution. With the CG converged (every column's relative residual at
    most 1.5·cg_tol, checked): the quadratic half −½yᵀα within
    2·cg_tol·|½yᵀα| (a residual of relative size cg_tol moves it by about
    that much), and every gradient entry within 10·cg_tol·max|g| (the
    gradient is bilinear in CG solutions whose residuals are at most
    cg_tol; on the H100 the reading is 4·cg_tol·max|g|). At the bench budget the
    CG's columns end unconverged (their relative residuals are printed; the
    stall latch freezes the gradient probes), so float32 and float64
    iterates differ by the truncation and only the log-det half is held."""
    import torch
    from mogptk_tpu_torch.gpr import iterative as it
    firsts = []
    for model in models:
        raws = model.trainable_raws()
        for r in raws:
            r.grad = None
        mv.mosm_matvec.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = model.loss()
        loss.backward()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t)
        firsts.append((float(loss.detach()), [r.grad.clone() for r in raws]))
        print("iterative first step (rank %d, %d CG iterations): loss %.6f in %.1f ms (K-matvec "
              "launches %d)" % (model.precond_rank, model.max_cg_iters, firsts[-1][0], step_ms,
                                mv.mosm_matvec.launches))
    phase("iterative: float64 executions of the first steps")
    refs = float64_iterative_executions(models, bm, mg)
    for i, (model, (loss1, grads1), (lml64, grads64, yterm64, parts64)) in enumerate(
            zip(models, firsts, refs)):
        _, yterm32, parts32 = first_step_parts(model, it)
        label = "bench budget" if i == 0 else "converged budget"
        g_scale = max(float(g.abs().max()) for g in grads64)
        d_grad = max(float((g.double() - r).abs().max()) for g, r in zip(grads1, grads64))
        cosine = float(sum(torch.sum(g.double() * r) for g, r in zip(grads1, grads64))
                       / torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads1)
                                    * sum(torch.sum(r ** 2) for r in grads64)))
        ld32 = float(parts32["logdetP"]) + float(parts32["quads"].mean())
        ld64 = float(parts64["logdetP"]) + float(parts64["quads"].mean())
        print("%s, float32 kernels: LML %.6f, −½yᵀα %.3f, %s" % (label, -loss1, yterm32,
                                                                describe(parts32)))
        print("%s, float64 execution: LML %.6f, −½yᵀα %.3f, %s" % (label, lml64, yterm64,
                                                                  describe(parts64)))
        d_lml, d_q, d_ld = abs(-loss1 - lml64), abs(yterm32 - yterm64), abs(ld32 - ld64)
        se = float(parts64["quads"].std() / np.sqrt(parts64["quads"].numel()))
        tol_ld = 3 * se
        ok_ld = d_ld <= tol_ld and np.isfinite(loss1) and all(
            bool(torch.isfinite(g).all()) for g in grads1)
        if i == 0:
            print("%s vs float64: log-det half %.3f vs %.3f, |d| %.3e (tol 3·SE = %.3e); "
                  "−½yᵀα |d| %.3e, LML |d| %.3e, gradient max|d| %.3e of max|g| %.3e, cosine "
                  "%.4f (unconverged: reported)" % (label, ld32, ld64, d_ld, tol_ld, d_q, d_lml,
                                                    d_grad, g_scale, cosine))
            if not ok_ld:
                fail("the first iterative step's log-det half disagrees with float64")
        else:
            worst = float(parts32["res"].max())
            if not worst <= 1.5 * model.cg_tol:
                fail("the converged budget left a CG column at relative residual %.3e" % worst)
            tol_q = 2 * model.cg_tol * abs(yterm64)
            tol_grad = 10 * model.cg_tol * g_scale
            print("%s vs float64: −½yᵀα |d| %.3e (tol 2·cg_tol·|½yᵀα| = %.3e); log-det half %.3f "
                  "vs %.3f, |d| %.3e (tol 3·SE = %.3e); LML |d| %.3e (the sum of the two halves' "
                  "limits, %.3e); gradient max|d| %.3e (tol 10·cg_tol·max|g| = %.3e, max|g| "
                  "%.3e), cosine %.6f"
                  % (label, d_q, tol_q, ld32, ld64, d_ld, tol_ld, d_lml, tol_q + 0.5 * tol_ld,
                     d_grad, tol_grad, g_scale, cosine))
            if not (ok_ld and d_q <= tol_q and d_lml <= tol_q + 0.5 * tol_ld
                    and d_grad <= tol_grad):
                fail("the converged first iterative step disagrees with its float64 execution")
    model = models[0]
    raws = model.trainable_raws()
    loss1, grads1 = firsts[0]
    for r in raws:
        r.grad = None
    loss = model.loss()
    loss.backward()
    if float(loss.detach()) != loss1 or not all(torch.equal(r.grad, g) for r, g in zip(raws, grads1)):
        fail("a repeated first iterative step gave another loss or gradient")
    print("iterative repeated first step: identical loss %.9g and gradients" % loss1)
    for r in raws:
        r.grad = None
    return loss1


def dense_float64_gram(mg, x, c, st3, st2, rows=2048):
    """The (N, N) float64 Gram of the plain pair-statistics formula, built in
    row blocks."""
    import torch
    n = x.shape[0]
    K = torch.empty((n, n), dtype=torch.float64, device=x.device)
    for r0 in range(0, n, rows):
        K[r0:r0 + rows] = mg.mosm_gram_pairstats_plain(x[r0:r0 + rows], c[r0:r0 + rows], x, c,
                                                         st3, st2)
    return K


def float64_iterative_executions(models, bm, mg):
    """The first iterative step of each model in float64 on the card, plain
    functions only, with each model's draws and budget; the models share
    their data, kernel and parameter values. The operator is the dense
    float64 Gram (34 GB at N=65,536), built once, with its rows for the
    pivots; the CG, quadrature and preconditioner are the same code
    (gpr.iterative.lml_iter_value); the gradient is the low-rank VJP's plain
    twin chained through the pair statistics by autograd. Returns, per
    model, (LML, gradient of the loss −LML per trainable raw, the quadratic
    half −½yᵀα, the estimator's parts)."""
    import torch
    from mogptk_tpu_torch.gpr import iterative as it
    from mogptk_tpu_torch.ops import iterative as ops_it
    model = models[0]
    lay = model._layout
    if lay["perm"] is not None:
        fail("the float64 execution expects channel-sorted data")
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
    x, c = lay["x"].double(), lay["c"]
    n = x.shape[0]
    scale_noise = value("likelihood.scale") ** 2
    noise = (scale_noise[c.long()] if scale_noise.ndim == 1
             else scale_noise.reshape(-1).expand(n)) + model.jitter
    kdiag = torch.sum(w ** 2 * kern.twopi * torch.sqrt(torch.prod(var, dim=-1)), dim=-1)[c.long()]
    y = model.y.double()
    solved = []
    with torch.no_grad():
        K = dense_float64_gram(mg, x, c, st3.detach(), st2.detach())
        nd = noise.detach()
        for m in models:
            L = ops_it.pivoted_cholesky(kdiag.detach(), lambda i: K[i], n, m.precond_rank)
            Z = m._Z.double()
            val, alpha, U, parts = it.lml_iter_value(
                lambda V: K @ V + nd[:, None] * V, L, torch.mean(nd), y, Z, m._u0.double(),
                m._u1.double(), m.max_cg_iters, m.cg_tol)
            solved.append((m, val, alpha, U, Z, parts))
            del L
        del K
        torch.cuda.empty_cache()
    out = []
    for m, val, alpha, U, Z, parts in solved:
        with torch.no_grad():
            lml = float(val) - m.log_marginal_likelihood_constant
            yterm = float(-0.5 * torch.sum(y * alpha))
            A = 0.5 * torch.cat([alpha, -U / m.num_probes], dim=1)
            B = torch.cat([alpha, Z], dim=1)
            dst3, dst2 = bm.mosm_lowrank_vjp_plain(x, lay["counts"], st3.detach(), st2.detach(),
                                                   A, B)
            ddiag = torch.sum(A * B, dim=1)
        grads = torch.autograd.grad((st3, st2, noise), raws, (dst3, dst2, ddiag),
                                    retain_graph=True, allow_unused=True)
        grads = [torch.zeros_like(r) if g is None else g for g, r in zip(grads, raws)]
        out.append((lml, [-g for g in grads], yterm, parts))
    return out


def readout_references(model, bm, mg, mv, terms, Z, rank, lanczos):
    """What a readout of `model` on the card is held against: the dense
    float64 truth (the plain Gram plus the noise, K̃, torch.linalg.cholesky);
    the float64 residual r = y − K̃α of the readout's α and ½α₆₄ᵀr, which is
    exactly what α's error moves −½yᵀα by; and the readout's log-det
    quadrature with its probes Z and its pivoted factor executed twice more,
    through K-matvec's float32 plain twin and in float64 (the factor
    upcast). Returns a dict of floats and the float64 execution's per-probe
    quadratures."""
    import torch
    from mogptk_tpu_torch.ops import iterative as ops_it
    lay = model._layout
    with torch.no_grad():
        L, sigma2, (st3, st2) = model._operator(rank)[2:]
        x, c = lay["x"], lay["c"]
        noise = lay.sort(model._noise_diag())
        Zs = lay.sort(Z)
        logdetP_t, vals_t = ops_it.preconditioned_slq_terms(
            lambda V: mv.mosm_matvec_plain(x, c, st3, st2, V) + noise[:, None] * V, L, sigma2, Zs,
            lanczos)
        p64 = [p.detach().double() for p in model.kernel._params()]
        st3, st2 = bm.mosm_pair_stats(*p64, model.kernel.twopi)
        K = dense_float64_gram(mg, x.double(), c, st3, st2)
        K.diagonal().add_(noise.double())
        y = lay.sort(model._residual_y().double())
        a32 = lay.sort(terms["alpha"].double())
        r = y - K @ a32
        logdetP, vals = ops_it.preconditioned_slq_terms(lambda V: K @ V, L.double(),
                                                        sigma2.double(), Zs.double(), lanczos)
        Lc = torch.linalg.cholesky(K)
        del K
        alpha = torch.cholesky_solve(y, Lc, upper=False)
        logdet = float(2.0 * torch.sum(torch.log(torch.diagonal(Lc))))
        del Lc
        quad = float(-0.5 * torch.sum(y * alpha))
        return dict(lml=quad - 0.5 * logdet - model.log_marginal_likelihood_constant, quad=quad,
                    logdet=logdet, res=float(torch.linalg.norm(r) / torch.linalg.norm(y)),
                    shift=float(0.5 * torch.sum(alpha * r)),
                    sum_bound=float(0.5 * torch.sum(torch.abs(y * a32))),
                    ld_twin=float(logdetP_t) + float(torch.mean(vals_t)),
                    logdetP_exec=float(logdetP), trlog_exec=float(torch.mean(vals)),
                    ld_exec=float(logdetP) + float(torch.mean(vals))), vals


def check_readout(model, bm, mg, mv, label):
    """log_marginal_likelihood_readout (rank 256, 64 probes, 64 Lanczos
    steps) against the dense float64 LML, each half on its own. Returns the
    list of the checks that failed (empty if none).

    - −½yᵀα: the readout's α leaves the float64 residual r, which moves
      −½yᵀα by ½α₆₄ᵀr exactly; the limit is twice that plus the float32
      rounding bound of the N-term sum, u·⌈log₂N⌉·½Σ|y∘α|; and ‖r‖/‖y‖
      must be under the training budget's cg_tol (r is measured, not
      trusted).
    - log det = log det P + tr log(P⁻¹K̃), the estimator: its float64
      execution with the readout's probes and factor within 4 standard
      errors of the dense float64 log det (SE from its per-probe
      quadratures: the estimator's own noise).
    - the same, float32 rounding: the readout through K-matvec at most
      twice as far from the float64 execution as the same quadrature
      through K-matvec's float32 plain twin, plus 1e-6 of |log det| for
      summation order alone."""
    import torch
    from mogptk_tpu_torch.gpr.model import generator, rademacher
    n = model.X.shape[0]
    P, lanczos = max(64, model.num_probes), max(64, model.lanczos_iters)
    rank = max(256, model.precond_rank)
    # the readout's own default draws, handed in so the executions below
    # get the same
    Z = rademacher(generator(model.seed + 1, model.device), (n, P), torch.float32, model.device)
    torch.cuda.synchronize()
    t = time.perf_counter()
    terms = model.readout_terms(probes=Z)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    t = time.perf_counter()
    ex, vals64 = readout_references(model, bm, mg, mv, terms, Z, rank, lanczos)
    ref_s = time.perf_counter() - t
    with torch.no_grad():
        train_est = float(model.log_marginal_likelihood())
    value = float(terms["value"])
    rel = abs(value - ex["lml"]) / abs(ex["lml"])
    quad = float(terms["quad"])
    d_q = abs(quad - ex["quad"])
    sum_tol = TWO_POW_M24 * np.ceil(np.log2(n)) * ex["sum_bound"]
    tol_q = 2 * abs(ex["shift"]) + sum_tol
    ld = float(terms["logdetP"]) + float(terms["trlog"])
    se = float(vals64.std() / np.sqrt(vals64.numel()))
    se32 = float(terms["trlog_probes"].std() / np.sqrt(terms["trlog_probes"].numel()))
    d_est = abs(ex["ld_exec"] - ex["logdet"])
    d_k, d_t = abs(ld - ex["ld_exec"]), abs(ex["ld_twin"] - ex["ld_exec"])
    tol_k = 2 * d_t + 1e-6 * abs(ex["logdet"])
    print("readout %s N=%d: %.4f in %.2f s; dense float64 LML %.4f (references %.2f s); relative "
          "error %.3e; training-path estimate %.4f (rel %.3e)"
          % (label, n, value, secs, ex["lml"], ref_s, rel, train_est,
             abs(train_est - ex["lml"]) / abs(ex["lml"])))
    print("  −½yᵀα %.6f vs %.6f: |d| %.3e (tol 2·|½α₆₄ᵀr| + u⌈log₂N⌉·½Σ|yα| = 2·%.3e + %.3e = "
          "%.3e); ‖r‖/‖y‖ %.3e (tol %.0e)"
          % (quad, ex["quad"], d_q, abs(ex["shift"]), sum_tol, tol_q, ex["res"],
             ITER_SETTINGS["cg_tol"]))
    print("  log det P + tr log(P⁻¹K̃) %.4f + %.4f = %.4f vs log det %.4f: |d| %.3e; float64 "
          "execution %.4f + %.4f = %.4f: vs log det |d| %.3e = %.2f SE (tol 4·SE, SE %.3e of %d "
          "probes; the readout's own %.3e); K-matvec vs the float64 execution |d| %.3e (twin "
          "%.3e, tol %.3e)"
          % (float(terms["logdetP"]), float(terms["trlog"]), ld, ex["logdet"],
             abs(ld - ex["logdet"]), ex["logdetP_exec"], ex["trlog_exec"], ex["ld_exec"], d_est,
             d_est / se, se, vals64.numel(), se32, d_k, d_t, tol_k))
    failed = []
    if not (np.isfinite(value) and d_q <= tol_q and ex["res"] <= ITER_SETTINGS["cg_tol"]):
        failed.append("the readout's quadratic half (%s) is off the dense float64 one" % label)
    if not d_est <= 4 * se:
        failed.append("the readout's log-det estimator (%s) is more than 4 SE off the dense "
                      "float64 log det" % label)
    if not d_k <= tol_k:
        failed.append("the readout's log-det half (%s) through K-matvec is further from its "
                      "float64 execution than twice the plain twin's" % label)
    return failed


def predict_at_bench_budget(gpr, model, Xc, Yc, Xq, mu64, bm, mg, dev):
    """Reported, not held: iterative predict_f at benchmarks/bignum_exact.py's
    budget (rank 64, 50 CG iterations) against the float64 reference, with
    the relative residual of its α solve, and a float64 execution of the
    same CG (the dense float64 operator, the same factor upcast, the same
    budget and latches), which tells the budget's error from float32's."""
    import torch
    from mogptk_tpu_torch.ops import iterative as ops_it
    it_b = gpr.ExactIterative(model.kernel, Xc, Yc, device=dev, **ITER_SETTINGS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    mu_b, _ = it_b.predict_f(Xq)
    torch.cuda.synchronize()
    pred_ms = 1e3 * (time.perf_counter() - t)
    res32 = it_b.cg_diagnostics()[0]
    lay = it_b._layout
    with torch.no_grad():
        p64 = [p.detach().double() for p in it_b.kernel._params()]
        st3, st2 = bm.mosm_pair_stats(*p64, it_b.kernel.twopi)
        x64 = lay["x"].double()
        K = dense_float64_gram(mg, x64, lay["c"], st3, st2)
        K.diagonal().add_(lay.sort(it_b._noise_diag().double()))
        L, sigma2 = it_b._operator(it_b.precond_rank)[2:4]
        M_inv = ops_it.woodbury_m_inv(L.double(), sigma2.double())[0]
        y = lay.sort(it_b._residual_y().double())
        alpha, res64 = ops_it.cg_solve(lambda V: K @ V, y, max_iters=it_b.max_cg_iters,
                                       tol=it_b.cg_tol, M_inv=M_inv)
        del K
        cq, xq = it_b.kernel._split(Xq.double())
        mu_x = mg.mosm_gram_pairstats_plain(x64, lay["c"], xq, cq, st3, st2).T @ alpha
    print("bench budget (rank %d, %d CG iterations) predict_f on request (a): %.1f ms; max|dmu| "
          "vs float64 %.3e (CG relative residual of y %.3e); float64 execution of the same "
          "budget: max|dmu| vs float64 %.3e (residual %.3e) (reported, not held)"
          % (it_b.precond_rank, it_b.max_cg_iters, pred_ms,
             float((mu_b.double() - mu64).abs().max()), res32,
             float((mu_x - mu64).abs().max()), float(res64[0])))


def check_readout_and_predict(gpr, xs, ys, X, Y, Xq, dev):
    """Phase 11: log_marginal_likelihood_readout against the dense float64
    LML (check_readout) at N=16,384 (the bench model) and at N=32,768 (the
    first half of each bignum channel), the phase failing after both have
    printed if either is off; on the bench model, iterative predict_f on
    request (a) with the converged budget against the port's
    Exact.predict_f with the same parameters and against a float64
    reference, and at the bench budget (reported)."""
    import torch
    from mogptk_tpu_torch.ops import block_mosm as bm, mosm_gram as mg, mosm_matvec as mv
    bx, by, mean, var = make_bignum_data()
    failed = []
    cases = [("bench model", X, Y, None)]
    half = [xc[:ITER_N_PER_CHANNEL // 2] for xc in bx], [yc[:ITER_N_PER_CHANNEL // 2] for yc in by]
    _, X2, Y2 = gpr.merge_data(*half, device=dev)
    cases.append(("bignum data, first half", X2, Y2, (mean, var)))
    for label, Xc, Yc, mv_ in cases:
        kernel = gpr.MultiOutputSpectralMixtureKernel(Q, output_dims=CHANNELS)
        if mv_ is None:
            set_bench_params(kernel)
        else:
            kernel.mean.assign(mv_[0])
            kernel.variance.assign(mv_[1])
        # predict's CG runs the model's budget: the converged one of phase 10
        model = gpr.ExactIterative(kernel, Xc, Yc, device=dev,
                                   **dict(ITER_SETTINGS, precond_rank=ITER_RANK_C,
                                          max_cg_iters=ITER_CG_C))
        failed += check_readout(model, bm, mg, mv, label)
        torch.cuda.empty_cache()
        if mv_ is not None:
            del model
            torch.cuda.empty_cache()
            continue
        torch.cuda.synchronize()
        t = time.perf_counter()
        mu_i, var_i = model.predict_f(Xq)
        torch.cuda.synchronize()
        pred_ms = 1e3 * (time.perf_counter() - t)
        ex = gpr.Exact(model.kernel, Xc, Yc, variance=0.1, device=dev)
        mu_e, var_e = ex.predict_f(Xq)
        with torch.no_grad():
            mu64, var64 = float64_reference(ex, Xq, bm, mg)
        with torch.no_grad():
            kss = float(model.kernel.K_diag(Xq).max())
        d_ie = (float((mu_i - mu_e).abs().max()), float((var_i - var_e).abs().max()))
        d_i64 = (float((mu_i.double() - mu64).abs().max()), float((var_i.double() - var64).abs().max()))
        # both within 1e-2 of each output's scale of the float64 reference
        # (as request (a) in phase 3), so within 2e-2 of each other
        tol_mu, tol_var = 1e-2 * float(mu64.abs().max()), 1e-2 * kss
        print("iterative predict_f on request (a) M=%d: %.1f ms; vs Exact.predict_f max|dmu| %.3e, "
              "max|dvar| %.3e (tol %.3e, %.3e); vs float64 %.3e, %.3e (tol %.3e, %.3e)"
              % (Xq.shape[0], pred_ms, d_ie[0], d_ie[1], 2 * tol_mu, 2 * tol_var, d_i64[0],
                 d_i64[1], tol_mu, tol_var))
        if not (d_ie[0] <= 2 * tol_mu and d_ie[1] <= 2 * tol_var
                and d_i64[0] <= tol_mu and d_i64[1] <= tol_var):
            fail("iterative predict_f disagrees with Exact predict or the float64 reference")
        predict_at_bench_budget(gpr, model, Xc, Yc, Xq, mu64, bm, mg, dev)
        del model, ex
        torch.cuda.empty_cache()
    # the readouts' checks fail the phase here, after every case has printed
    if failed:
        fail("; ".join(failed))


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


# each check_first_step's result by label: the loss, the gradient, the
# float64 reference and the probes it was taken with
FIRST_STEPS = {}
# each train_and_count's median step ms by label
STEP_MS = {}


def check_first_step(model, bm, mg, label, like=None):
    """The model's first training step (loss and every raw's gradient)
    against float64_training_reference within κ·u, then once more for a
    bit-identical loss and gradient. With `like`, the label of an earlier
    check of a model with the same parameters, data and probes, its float64
    reference is reused and the step's distance from that check's step is
    printed. Returns the first loss."""
    import torch
    raws = model.trainable_raws()
    for r in raws:
        r.grad = None
    loss = model.loss()
    loss.backward()
    torch.cuda.synchronize()
    loss1 = float(loss.detach())
    grads1 = [r.grad.clone() for r in raws]
    if like is None:
        phase("%s: float64 reference of the first step" % label)
        ref = float64_training_reference(model, bm, mg)
    else:
        prev = FIRST_STEPS[like]
        same_probes = (prev["probes"] is None) == (model.probes is None) and (
            model.probes is None or torch.equal(prev["probes"], model.probes))
        if not same_probes:
            fail("%s: the probes differ from those of the %s step" % (label, like))
        ref = prev["ref"]
        print("%s first step vs the %s step: |dLML| %.3e, gradient max|d| %.3e"
              % (label, like, abs(loss1 - prev["loss"]),
                 max(float((g - h).abs().max()) for g, h in zip(grads1, prev["grads"]))))
    lml64, grads64, scale_lml = ref
    FIRST_STEPS[label] = dict(loss=loss1, grads=grads1, ref=ref,
                              probes=None if model.probes is None else model.probes.clone())
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


def train_and_count(gpr, model, counters, want, loss1, label, smi, steps=TRAIN_STEPS):
    """`steps` Adam steps of gpr.train with every count set to 0 first;
    each step must launch each kernel as `want` says ((least, exact or
    None)). Returns the counts of the whole run."""
    import torch
    phase("%s: %d training steps" % (label, steps))
    for f in counters.values():
        f.launches = 0
    stamps = []

    def on_step(i, value):
        stamps.append((time.perf_counter(), value, {k: f.launches for k, f in counters.items()}))

    torch.cuda.synchronize()
    t_start = time.perf_counter()
    losses, _ = gpr.train(model, method="Adam", lr=1e-3, iters=steps, callback=on_step)
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
    STEP_MS[label] = med
    print("%s training: %d Adam steps at N=%d, median step %.2f ms, %.3f steps/s (%s)"
          % (label, steps, model.X.shape[0], med, 1e3 / med, smi.stdout.strip().splitlines()[0]))
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


# -- phases 16-18: the other multi-output families -----------------------------

FAMILY_NAMES = ("umosm", "csm", "conv", "mohsm", "lmc_sm")
FAM_CHANNELS, FAM_N_PER = 2, 2048     # benchmarks/family_bench.py: N = 4,096
FAM_PROBES = 16
FAM_RANKS = (1, 17, 33, 65)
FAM_PREDICT = 1024
FULL_FAMILIES = ("csm", "lmc_sm")     # phase 16 at bench.py's full width too


def canary_data(gpr, dev):
    """benchmarks/tpu_canary.py _data(2, 2048): 2 channels x 2,048 sorted
    points on [0, 6]."""
    rng = np.random.RandomState(0)
    xs, ys = [], []
    for j in range(FAM_CHANNELS):
        x = np.sort(rng.uniform(0.0, 6.0, FAM_N_PER)).reshape(-1, 1)
        xs.append(x)
        ys.append((np.sin(1.2 * x[:, 0] + j) + 0.05 * rng.randn(FAM_N_PER)).reshape(-1, 1))
    return xs, ys, gpr.merge_data(xs, ys, device=dev)


def family_kernel(gpr, name, channels=FAM_CHANNELS):
    """benchmarks/tpu_canary.py _family_kernel(name, RandomState(1),
    channels): CSM with Rq = 2, SM-LMC with Q = 2 and Rq = 2, MOHSM under
    psd_safe (as benchmarks/family_bench.py times it)."""
    rng = np.random.RandomState(1)
    if name == "umosm":
        k = gpr.UncoupledMultiOutputSpectralKernel(output_dims=channels)
        k.weight.assign(np.tril(0.5 + rng.rand(channels, channels)))
        k.mean.assign(0.1 + 0.1 * rng.rand(channels, 1))
        k.variance.assign(0.3 + 0.1 * rng.rand(channels, 1))
    elif name == "csm":
        k = gpr.CrossSpectralKernel(output_dims=channels, Rq=2)
        k.mean.assign(0.1 + 0.1 * rng.rand(1))
        k.variance.assign(0.3 + 0.1 * rng.rand(1))
        k.amplitude.assign(0.5 + rng.rand(channels, 2))
    elif name == "conv":
        k = gpr.GaussianConvolutionProcessKernel(output_dims=channels)
        k.variance.assign(0.3 + 0.1 * rng.rand(channels, 1))
    elif name == "lmc_sm":
        spectral = [gpr.SpectralKernel(1) for _ in range(2)]
        for kq in spectral:
            kq.mean.assign(0.1 + 0.1 * rng.rand(1))
            kq.variance.assign(0.3 + 0.1 * rng.rand(1))
        k = gpr.LinearModelOfCoregionalizationKernel(spectral, output_dims=channels, Q=2, Rq=2)
        k.weight.assign(0.3 + 0.5 * rng.rand(channels, 2, 2))
    else:
        k = gpr.MultiOutputHarmonizableSpectralKernel(output_dims=channels, psd_safe=True)
        k.mean.assign(0.1 + 0.1 * rng.rand(channels, 1))
        k.variance.assign(0.9 + 0.2 * rng.rand(channels, 1))
        k.lengthscale.assign(0.25 + 0.1 * rng.rand(channels))
    return k


def family_ops(family, D, kind):
    """FP32 operations of one element of a family's Gram (a transcendental
    function counted as one, as gram_ops does): its value chain (kind
    "value"), or with kind "grad" that chain, one more per sine and four per
    scalar of the pack (csrc/family_element.cuh)."""
    name, statics = family
    A = statics[0] if name in ("csm", "lmc_sm") else 0
    value = {"umosm": 6 * D + 7, "mohsm": 10 * D + 9, "csm": 5 * D + 2 + 5 * A,
             "conv": 4 * D + 3, "lmc_sm": A * (8 * D + 2)}[name]
    if kind == "value":
        return value
    S = {"umosm": 3 * D + 2, "csm": 2 * D + 2 * A, "conv": D + 1, "mohsm": 4 * D + 3,
         "lmc_sm": A + 2 * A * D}[name]
    sines = {"umosm": 1, "mohsm": 1, "csm": A, "conv": 0, "lmc_sm": A * D}[name]
    return value + sines + 4 * S


def fam_chain(pack, params, dpack):
    """The parameters' cotangents (float64) of a pack cotangent, through the
    family's pack function (the chain the training paths apply)."""
    import torch
    return [g.double() for g in torch.autograd.grad(pack, params, dpack.to(pack.dtype),
                                                    retain_graph=True)]


def check_family_kernels(gpr, bf, family, kernel, x, c, perm, label, slice_rows=None):
    """Phase 16 for one family at one size: K-fam-gram, K-fam-gram-bwd,
    K-fam-matvec (R = 1, 17, 33, 65) and K-fam-lowrank-vjp (the same R)
    against their plain twins, on channel-sorted points and on the same
    points permuted; each repeat bit-identical. The backward kernels are
    held as parameter cotangents against a float64 twin (twice the float32
    twin's distance plus 1e-5 of the scale); K-fam-gram within 2e-4·max|K|
    of its twin (float32 cosines of arguments of tens of radians, FMA
    contraction); K-fam-matvec against a float64 twin within twice the
    float32 twin plus 1e-6 of max|K|·|V|. Where the twin of K-fam-gram-bwd
    at full size takes seconds (slice_rows), it is compared on that many
    rows of g and timed once at full size. Returns the report entries of the
    last shapes checked: K-fam-gram and K-fam-gram-bwd on sorted points,
    K-fam-matvec at R = 33 and K-fam-lowrank-vjp at R = 17 (the iterative and
    probe-trace paths' ranks)."""
    import torch
    n, D = x.shape
    params = kernel.trainable_raws()
    pack = bf.family_pack(family, kernel._fused_params())
    p, p64 = pack.detach(), pack.detach().double()
    counts = tuple(int(k) for k in torch.bincount(c.long()).tolist())
    xp, cp = x[perm].contiguous(), c[perm].contiguous()
    rng = np.random.RandomState(9)
    report = {}
    # the twins at full width take seconds a call: one timed call each
    preps, pwarm = (1, 0) if n > 8192 else (2, 1)
    fwd_ops, bwd_ops = family_ops(family, D, "value"), family_ops(family, D, "grad")
    with torch.no_grad():
        for how, xx, cc in (("sorted", x, c), ("permuted", xp, cp)):
            got = bf.family_gram(family, xx, cc, xx, cc, p)
            twin = bf.family_gram_plain(family, xx, cc, xx, cc, p)
            kmax = float(twin.abs().max())
            err = float((got - twin).abs().max())
            del got, twin
            ms = median_ms(lambda: bf.family_gram(family, xx, cc, xx, cc, p), reps=5)
            pms = median_ms(lambda: bf.family_gram_plain(family, xx, cc, xx, cc, p), reps=preps,
                            warmup=pwarm)
            bnd = bound(4 * n * n, n * n * fwd_ops)
            print("K-fam-gram %s %s %dx%d: max_abs_err %.3e (tol %.3e), kernel %.3f ms, plain "
                  "%.3f ms, bound %.3f ms (%s)" % ((label, how, n, n, err, 2e-4 * kmax, ms, pms)
                                                   + bnd))
            if not err <= 2e-4 * kmax:
                fail("K-fam-gram %s %s disagrees with its plain twin" % (label, how))
            if how == "sorted":
                report["family_gram"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                             library_ms=None, bound=bnd)
    for how, xx, cc in (("sorted", x, c), ("permuted", xp, cp)):
        cts = counts if how == "sorted" else None
        G = torch.as_tensor(rng.randn(n, n), dtype=torch.float32, device=x.device)
        got = bf.family_gram_bwd(family, xx, cc, xx, cc, p, G, cts, cts)
        again = bf.family_gram_bwd(family, xx, cc, xx, cc, p, G, cts, cts)
        if not torch.equal(got, again):
            fail("K-fam-gram-bwd %s %s: a repeated call differs" % (label, how))
        rows = n if slice_rows is None else slice_rows
        sl = slice(0, rows)
        x1, c1, Gs = xx[sl].contiguous(), cc[sl].contiguous(), G[sl].contiguous()
        got_s = got if rows == n else bf.family_gram_bwd(family, x1, c1, xx, cc, p, Gs)
        k = fam_chain(pack, params, got_s)
        t = fam_chain(pack, params, bf.family_gram_bwd_plain(family, x1, c1, xx, cc, p, Gs))
        r = fam_chain(pack, params, bf.family_gram_bwd_plain(
            family, x1.double(), c1, xx.double(), cc, p64, Gs.double()))
        d_k, d_t, tol = held("K-fam-gram-bwd %s %s" % (label, how), "parameter cotangents", k, t,
                             r, 1e-5)
        ms = median_ms(lambda: bf.family_gram_bwd(family, xx, cc, xx, cc, p, G, cts, cts), reps=5)
        pms = median_ms(lambda: bf.family_gram_bwd_plain(family, xx, cc, xx, cc, p, G),
                        reps=preps, warmup=pwarm)
        bnd = bound(4 * n * n, n * n * bwd_ops)
        print("K-fam-gram-bwd %s %s %dx%d%s: parameter cotangents vs float64 %.3e (twin %.3e, tol "
              "%.3e), bit-identical repeat, kernel %.3f ms, plain %.3f ms, bound %.3f ms (%s)"
              % ((label, how, n, n, "" if rows == n else " (compared on %d rows)" % rows, d_k,
                  d_t, tol, ms, pms) + bnd))
        if how == "sorted":
            report["family_gram_bwd"] = dict(max_abs_err=max(float((a - b).abs().max())
                                                             for a, b in zip(k, t)),
                                             ms=ms, plain_ms=pms, library_ms=None, bound=bnd)
        del G, Gs, got, again, got_s
    with torch.no_grad():
        for R in FAM_RANKS:
            V = torch.as_tensor(rng.randn(n, R), dtype=torch.float32, device=x.device)
            for how, xx, cc, VV in (("sorted", x, c, V), ("permuted", xp, cp, V[perm].contiguous())):
                got = bf.family_matvec(family, xx, cc, p, VV)
                if not torch.equal(got, bf.family_matvec(family, xx, cc, p, VV)):
                    fail("K-fam-matvec %s %s R=%d: a repeated call differs" % (label, how, R))
                twin = bf.family_matvec_plain(family, xx, cc, p, VV)
                ref = bf.family_matvec_plain(family, xx.double(), cc, p64, VV.double())
                scale = max(float((bf.family_gram_plain(family, xx[r0:r0 + 2048], cc[r0:r0 + 2048],
                                                        xx, cc, p).abs() @ VV.abs()).max())
                            for r0 in range(0, n, 2048))
                d_k = float((got.double() - ref).abs().max())
                d_t = float((twin.double() - ref).abs().max())
                tol = 2 * d_t + 1e-6 * scale
                if not d_k <= tol:
                    fail("K-fam-matvec %s %s R=%d is further from float64 (%.3e) than twice its "
                         "twin (%.3e)" % (label, how, R, d_k, d_t))
                ms = median_ms(lambda: bf.family_matvec(family, xx, cc, p, VV), reps=5)
                pms = median_ms(lambda: bf.family_matvec_plain(family, xx, cc, p, VV), reps=preps,
                                warmup=pwarm)
                lms = median_ms(lambda: torch.matmul(bf.family_gram(family, xx, cc, xx, cc, p), VV),
                                reps=3)
                bnd = bound(4 * (n * (D + 1) + 2 * n * R), n * n * (fwd_ops + 2 * R))
                print("K-fam-matvec %s %s N=%d R=%d: vs float64 %.3e (twin %.3e, tol %.3e), "
                      "bit-identical repeat, kernel %.3f ms, plain %.3f ms, K-fam-gram + "
                      "torch.matmul %.3f ms, bound %.3f ms (%s)"
                      % ((label, how, n, R, d_k, d_t, tol, ms, pms, lms) + bnd))
                if how == "sorted" and R == 33:
                    report["family_matvec"] = dict(max_abs_err=float((got - twin).abs().max()),
                                                   ms=ms, plain_ms=pms, library_ms=lms, bound=bnd)
                del got, twin, ref
    for R in FAM_RANKS:
        A = torch.as_tensor(rng.randn(n, R), dtype=torch.float32, device=x.device)
        B = torch.as_tensor(rng.randn(n, R), dtype=torch.float32, device=x.device)
        got = bf.family_lowrank_vjp_sorted(family, x, counts, p, A, B)
        if not torch.equal(got, bf.family_lowrank_vjp_sorted(family, x, counts, p, A, B)):
            fail("K-fam-lowrank-vjp %s R=%d: a repeated call differs" % (label, R))
        k = fam_chain(pack, params, got)
        t = fam_chain(pack, params, bf.family_lowrank_vjp_plain(family, x, counts, p, A, B))
        r = fam_chain(pack, params, bf.family_lowrank_vjp_plain(family, x.double(), counts, p64,
                                                                A.double(), B.double()))
        d_k, d_t, tol = held("K-fam-lowrank-vjp %s R=%d" % (label, R), "parameter cotangents", k,
                             t, r, 1e-5)
        ms = median_ms(lambda: bf.family_lowrank_vjp_sorted(family, x, counts, p, A, B), reps=5)
        pms = median_ms(lambda: bf.family_lowrank_vjp_plain(family, x, counts, p, A, B),
                        reps=preps, warmup=pwarm)
        # the function needs each of the N(N+1)/2 upper elements once: 4R
        # FMAs for g (both directions; 2R on the diagonal) and its element
        # derivatives
        upper = n * (n + 1) // 2
        bnd = bound(4 * n * (2 * R + D), upper * (4 * R + bwd_ops))
        print("K-fam-lowrank-vjp %s N=%d R=%d: parameter cotangents vs float64 %.3e (twin %.3e, "
              "tol %.3e), bit-identical repeat, kernel %.3f ms, plain %.3f ms, bound %.3f ms (%s)"
              % ((label, n, R, d_k, d_t, tol, ms, pms) + bnd))
        if R == 17:
            report["family_lowrank_vjp"] = dict(max_abs_err=max(float((a - b).abs().max())
                                                                for a, b in zip(k, t)),
                                                ms=ms, plain_ms=pms, library_ms=None, bound=bnd)
        del A, B, got
    torch.cuda.empty_cache()
    return report


def family_counters():
    from mogptk_tpu_torch.ops import block_families as bf
    from mogptk_tpu_torch.ops import blocked_cholesky as bc, fused_solve as fs
    return {"family_gram": bf.family_gram, "family_gram_bwd": bf.family_gram_bwd,
            "family_matvec": bf.family_matvec, "family_lowrank_vjp": bf.family_lowrank_vjp_sorted,
            "s_panel": bc.s_panel, "col_write": bc.col_write, "fused_cho_solve": fs.fused_cho_solve}


PROBE_WANT = {"family_gram": (1, 1), "family_lowrank_vjp": (1, 1), "family_gram_bwd": (0, 0),
              "family_matvec": (0, 0)}
CLOSED_WANT = {"family_gram": (1, 1), "family_gram_bwd": (1, 1), "family_lowrank_vjp": (0, 0),
               "family_matvec": (0, 0)}


@contextlib.contextmanager
def gram_last_bit(seed):
    """Inside, the family kernels' plain Gram differs from its value by
    about one unit in the last place at random entries (+1, 0 or -1 times
    |K|·2⁻²⁴, seeded): as far as K-fam-gram is from its twin (phase 16)."""
    import torch
    from mogptk_tpu_torch.ops import block_families as bf
    orig = bf.family_gram_plain
    gens = {}

    def perturbed(*args):
        K = orig(*args)
        if K.device not in gens:
            gens[K.device] = torch.Generator(device=K.device).manual_seed(seed)
        sign = torch.randint(-1, 2, K.shape, generator=gens[K.device], device=K.device).to(K.dtype)
        return K + sign * K.abs() * 2.0 ** -24

    bf.family_gram_plain = perturbed
    try:
        yield
    finally:
        bf.family_gram_plain = orig


def fam_first_step(gpr, _build, model, rebuild, label):
    """The model's first step (loss and every raw's gradient) through the
    kernels against a float64 execution on the card, then once more for a
    bit-identical loss and gradient. Returns the first loss.

    The float32 yardstick is the execution with the family kernels' plain
    twins; it runs the blocked Cholesky's kernels as the kernels' execution
    does (they sum their panels in another order than their twins, cuBLAS,
    and are held in phases 2-5), so the two differ only in the family
    kernels. The kernels' execution must be at most twice as far from
    float64 as the twins', plus twice the spread that the Gram's last bit
    alone causes (the twins' execution again with gram_last_bit), plus 1e-5
    of the scale: at these conditions (κ ~ 1e4) one unit in the last place
    of the Gram, which K-fam-gram may differ from its twin by, moves a
    float32 first step by as much as the kernels do."""
    import torch
    first = step_outputs(model)
    (got, twin, ref), _ = three_ways(gpr, _build, model, rebuild, step_outputs,
                                     twins=family_twins)
    with family_twins(_build), gram_last_bit(11):
        bit = [t.double() for t in step_outputs(model)]
    print("%s first step: loss %.6f (float64 %.6f)" % (label, float(got[0]), float(ref[0])))
    if not all(torch.equal(a.double(), b) for a, b in zip(first, got)):
        fail("%s: the first step's executions differ" % label)
    for what, sl in (("loss", slice(0, 1)), ("gradient", slice(1, None))):
        scale = max(float(r.abs().max()) for r in ref[sl])
        spread = max(float((b - t).abs().max()) for b, t in zip(bit[sl], twin[sl]))
        print("%s %s: the Gram's last bit moves the twins' execution by %.4e" % (label, what,
                                                                                 spread))
        held(label, what, got[sl], twin[sl], ref[sl], 1e-5 + 2 * spread / scale)
    if not all(torch.equal(a, b) for a, b in zip(step_outputs(model), first)):
        fail("%s: a repeated first step gave another loss or gradient" % label)
    return float(first[0])


def drive_family_exact(gpr, _build, name, X, Y, dev, smi, Xq=None, kernel_fn=None):
    """Phase 17 (and 18 for CSM at full width) for one family: gpr.Exact
    with trace_probes=16 (the fused LML: K-fam-gram, K-spanel, K-colwrite,
    K-solve, K-fam-lowrank-vjp) and closed-form (K-fam-gram, the inverse,
    K-fam-gram-bwd), each first step against float64 and the float32 twins,
    then three counted Adam steps each; predict_y of Xq; the Gram's forward
    time. Returns (gram_fwd_ms, probe_step_ms, launches of the probe-trace
    and the closed-form runs)."""
    import torch
    kernel_fn = kernel_fn or (lambda: family_kernel(gpr, name))
    counters = family_counters()
    n = X.shape[0]
    out = {}
    for how, probes in (("probe-trace", FAM_PROBES), ("closed-form", None)):
        model = gpr.Exact(kernel_fn(), X, Y, variance=0.1, trace_probes=probes, device=dev)
        if (model._fused_static() is None) == bool(probes):
            fail("%s %s: the fused probe-trace LML did not engage as it should" % (name, how))
        Z = model.probes

        def rebuild():
            return gpr.Exact(kernel_fn(), X.double(), Y.double(), variance=0.1, device=dev,
                             probes=None if Z is None else Z.double())

        label = "%s %s N=%d" % (name, how, n)
        loss1 = fam_first_step(gpr, _build, model, rebuild, label)
        want = dict(PROBE_WANT if probes else CLOSED_WANT)
        want.update({"s_panel": (1, None), "col_write": (1, None), "fused_cho_solve": (0, None)})
        for f in counters.values():
            f.launches = 0
        out[how] = train_and_count(gpr, model, counters, want, loss1, label, smi)
        if probes:
            step_ms = train_ms(gpr, model)
            with torch.no_grad():
                gram_ms = median_ms(lambda: model.kernel.K_sorted(model.X, model._channel_counts),
                                    reps=5)
            if Xq is not None:
                model.predict_y(Xq, sigma=2)
                torch.cuda.synchronize()
                t = time.perf_counter()
                mu, lo, up = model.predict_y(Xq, sigma=2)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t)
                if not (bool(torch.isfinite(mu).all()) and bool((lo < mu).all())
                        and bool((mu < up).all())):
                    fail("%s: predict_y gave a non-finite answer or bands that do not bracket it"
                         % label)
                print("%s predict_y of %d points: %.2f ms" % (label, Xq.shape[0], ms))
        del model
        torch.cuda.empty_cache()
    return gram_ms, step_ms, out["probe-trace"], out["closed-form"]


def train_ms(gpr, model, steps=5):
    """Median ms of `steps` further Adam steps (host clock between the
    trainer's synchronizing callbacks), as family_bench.py's probe_step_ms
    (LML, gradient and the Adam update)."""
    import torch
    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpr.train(model, method="Adam", lr=1e-3, iters=steps,
              callback=lambda i, v: stamps.append(time.perf_counter()))
    return 1e3 * float(np.median(np.diff([t0] + stamps)[1:]))


def family_requests(dev, m=FAM_PREDICT):
    """m query points over the channels of the canary data, x in [0, 6.6]."""
    import torch
    rng = np.random.RandomState(7)
    per = m // FAM_CHANNELS
    return torch.as_tensor(np.concatenate([np.stack([np.full(per, float(j)),
                                                     np.sort(rng.uniform(0.0, 6.6, per))], axis=1)
                                           for j in range(FAM_CHANNELS)]),
                           dtype=torch.float32, device=dev)


def drive_families(gpr, _build, dev, smi):
    """Phases 16 and 17: each family's four kernels against their twins at
    family_bench.py's configuration (N = 4,096), then gpr.Exact on each;
    prints family_bench.py's JSON line per family."""
    import torch
    from mogptk_tpu_torch.ops import block_families as bf
    xs, ys, (_, X, Y) = canary_data(gpr, dev)
    perm = torch.as_tensor(np.random.RandomState(5).permutation(X.shape[0]), device=dev)
    phase("phase 16: the family kernels against their twins (N=%d)" % X.shape[0])
    for name in FAMILY_NAMES:
        kernel = family_kernel(gpr, name).to(dev)
        c, x = kernel._split(X)
        check_family_kernels(gpr, bf, kernel.family, kernel, x, c, perm, "%s N=%d" % (name,
                                                                                   X.shape[0]))
    phase("phase 17: the five families through gpr.Exact (N=%d)" % X.shape[0])
    Xq = family_requests(dev)
    for name in FAMILY_NAMES:
        gram_ms, step_ms, _, _ = drive_family_exact(gpr, _build, name, X, Y, dev, smi, Xq)
        print(json.dumps({"family": name, "n": int(X.shape[0]), "gram_fwd_ms": gram_ms,
                          "probe_step_ms": step_ms}))
    return xs, ys


def drive_families_full(gpr, _build, xs16, ys16, X16, Y16, reqs, fam_xs, fam_ys, dev, smi):
    """Phase 18 at bench.py's full width (4 x 4,096 points, N = 16,384):
    the kernels of CSM and SM-LMC against their twins (phase 16's checks);
    the SM_LMC named model through the user API; gpr.Exact with
    CrossSpectralKernel(Rq=2), probe-trace and closed-form, and a 4,096-point
    predict request; one ExactIterative step of the CSM at the bench budget
    against its float64 execution; then the CSM, CONV and MOHSM named models
    (MixtureKernel: the dense formulations, as in the JAX package) three
    steps each at N = 4,096. Returns (the kernels' report entries, the
    launches of the main path: the CSM's probe-trace and closed-form steps
    and the iterative step)."""
    import torch
    import mogptk_tpu_torch as mogptk
    from mogptk_tpu_torch.ops import block_families as bf
    n = X16.shape[0]
    perm = torch.as_tensor(np.random.RandomState(5).permutation(n), device=dev)
    report = {}
    for name in FULL_FAMILIES:
        kernel = family_kernel(gpr, name, channels=CHANNELS).to(dev)
        c, x = kernel._split(X16)
        rep = check_family_kernels(gpr, bf, kernel.family, kernel, x, c, perm,
                                   "%s N=%d" % (name, n), slice_rows=2048)
        if name == "csm":
            report = rep

    counters = family_counters()
    phase("phase 18: SM_LMC through the user API (N=%d)" % n)
    ds = mogptk.DataSet([xc[:, 0] for xc in xs16], [yc[:, 0] for yc in ys16])
    api = mogptk.SM_LMC(ds, Q=2, Rq=2)
    if api.gpr.X.device.type != dev.type or api.gpr.kernel.family is None:
        fail("SM_LMC did not build its block-engine kernel on the card")
    t = time.perf_counter()
    api.init_parameters("BNSE", iters=20)
    torch.cuda.synchronize()
    print("SM_LMC.init_parameters('BNSE', iters=20): %.2f s" % (time.perf_counter() - t))
    for f in counters.values():
        f.launches = 0
    losses, _ = api.train(method="Adam", lr=0.01, iters=TRAIN_STEPS)
    raised = {k: f.launches for k, f in counters.items()}
    print("SM_LMC.train(Adam, lr=0.01, iters=%d): losses %s, step ms %s, launches %s"
          % (TRAIN_STEPS, np.round(losses, 4).tolist(), np.round(1e3 * np.diff(api.times), 2)
             .tolist(), raised))
    if not np.all(np.isfinite(losses)):
        fail("SM_LMC.train gave a non-finite loss")
    if raised["family_gram_bwd"] != TRAIN_STEPS or raised["family_gram"] < TRAIN_STEPS:
        fail("SM_LMC.train did not go through K-fam-gram and K-fam-gram-bwd once a step")
    _, Mu, Lo, Up = api.predict()
    if not all(np.all(np.isfinite(m)) and np.all(lo < m) and np.all(m < up)
               for m, lo, up in zip(Mu, Lo, Up)):
        fail("SM_LMC.predict: a non-finite answer or bands that do not bracket it")
    mae = api.error("MAE")
    print("SM_LMC.predict() and error('MAE') = %.6f" % mae)
    if not np.isfinite(mae):
        fail("SM_LMC.error is not finite")
    del api
    torch.cuda.empty_cache()

    phase("phase 18: CrossSpectralKernel(Rq=2) through gpr.Exact (N=%d)" % n)
    csm = lambda: family_kernel(gpr, "csm", channels=CHANNELS)
    _, step_ms, probe_launches, closed_launches = drive_family_exact(
        gpr, _build, "csm", X16, Y16, dev, smi, reqs["c"], kernel_fn=csm)
    print("csm N=%d: probe-trace step %.2f ms" % (n, step_ms))

    phase("phase 18: one ExactIterative step of the CSM at the bench budget (N=%d)" % n)
    model = gpr.ExactIterative(csm(), X16, Y16, device=dev, **ITER_SETTINGS)

    def rebuild():
        return gpr.ExactIterative(csm(), X16.double(), Y16.double(), device=dev,
                                  probes=model._Z.double(),
                                  p_normals=(model._u0.double(), model._u1.double()),
                                  **ITER_SETTINGS)

    for f in counters.values():
        f.launches = 0
    fam_first_step(gpr, _build, model, rebuild, "csm ExactIterative N=%d" % n)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for f in counters.values():
        f.launches = 0
    losses, _ = gpr.train(model, method="Adam", lr=1e-3, iters=1)
    torch.cuda.synchronize()
    iter_launches = {k: f.launches for k, f in counters.items()}
    print("csm ExactIterative step: loss %.4f, %.2f ms, launches %s"
          % (losses[0], 1e3 * (time.perf_counter() - t), iter_launches))
    if iter_launches["family_matvec"] < 1 or iter_launches["family_lowrank_vjp"] != 1:
        fail("the iterative step did not go through K-fam-matvec and K-fam-lowrank-vjp")
    del model
    torch.cuda.empty_cache()

    phase("phase 18: the CSM, CONV and MOHSM named models (N=%d)" % (FAM_CHANNELS * FAM_N_PER))
    ds4 = mogptk.DataSet([xc[:, 0] for xc in fam_xs], [yc[:, 0] for yc in fam_ys])
    # MOHSM trains from its constructor's draws: its LS estimate on these
    # 2,048 closely spaced points per channel puts spectral means near 1e7,
    # where the float32 cosines are noise and the factor fails
    for which, build, init in (("CSM", lambda: mogptk.CSM(ds4, Q=2, Rq=2), "LS"),
                               ("CONV", lambda: mogptk.CONV(ds4, Q=2), "LS"),
                               ("MOHSM", lambda: mogptk.MOHSM(ds4, P=1, Q=2, psd_safe=True),
                                None)):
        gpr.set_seed(0)
        m = build()
        if init:
            m.init_parameters(init)
        losses, _ = m.train(method="Adam", lr=0.01, iters=TRAIN_STEPS)
        print("%s (init %s) train: losses %s, step ms %s"
              % (which, init or "by the constructor", np.round(losses, 4).tolist(),
                 np.round(1e3 * np.diff(m.times), 2).tolist()))
        if not np.all(np.isfinite(losses)):
            fail("%s.train gave a non-finite loss" % which)
        del m
        torch.cuda.empty_cache()
    launches = {"family_gram": probe_launches["family_gram"],
                "family_lowrank_vjp": probe_launches["family_lowrank_vjp"],
                "family_gram_bwd": closed_launches["family_gram_bwd"],
                "family_matvec": iter_launches["family_matvec"]}
    return report, launches


# -- phases 19-20: the fused below-TRSM column loop and the block-lower syrk ----

FUSED_J = 16       # the block column whose kernels phase 19 holds to their twins


def syrk_ops(n, block):
    """FP32 operations of the block-lower half of WᵀW for lower-triangular
    W at `block` granularity: element (a, b) sums k from max(a, b) to n."""
    a = np.arange(n, dtype=np.float64)
    below = 2 * (n - a) * (a + 1)                      # b <= a: max = a
    end = (np.arange(n) // block + 1) * block          # b in (a, end of a's block)
    # Σ_{b=a+1}^{end-1} 2(n - b)
    cnt = end - 1 - a
    above = 2 * (cnt * n - (a + 1 + end - 1) * cnt / 2)
    return float(np.sum(below + above))


def check_fused_kernels(gpr, bm, bc, bt, X, Y, dev):
    """Phase 19: K-sdiag, K-below-trsm and K-commit at block column
    FUSED_J of the bench model's noisy Gram (left columns the real factor,
    column j still K), K-syrk on W = L⁻¹ of the bench factor, each against
    its plain twin; then the whole fused factor against the unfused one
    and column by column (fused_by_column). Returns the report entries."""
    import torch
    report = {}
    u = TWO_POW_M24
    n, B = X.shape[0], 512
    j = min(FUSED_J, n // B - 2)
    r0 = j * B
    m = n - r0
    model = bench_model(gpr, X, Y, dev, None)
    with torch.no_grad():
        c, x = model.kernel._split(model.X)
        params = model.kernel._params()
        K = bm.mosm_gram_sorted(x, model._channel_counts, *params, model.kernel.twopi)
        K.diagonal().add_(model._noise_diag(add_jitter=True))
        Lfull = torch.linalg.cholesky(K)
        buf = K.clone()
        buf[:, :r0] = Lfull[:, :r0]
        del model

        C = buf[r0:r0 + B, :r0]
        got, err, worst = sdiag_against_twin(bc, buf, j, B)
        ref = bc.s_diag_plain(buf, j, B)
        ms = median_ms(lambda: bc.s_diag(buf, j, B))
        pms = median_ms(lambda: bc.s_diag_plain(buf, j, B))
        lms = median_ms(lambda: torch.addmm(buf[r0:r0 + B, r0:r0 + B], C, C.T, alpha=-1.0))
        bnd = sdiag_bound(r0, B)
        print("K-sdiag j=%d (r0=%d, B=%d, %d k chunks): max_abs_err %.3e, worst err/bound %.3f, "
              "kernel %.3f ms, plain %.3f ms, cuBLAS addmm %.3f ms, bound %.3f ms (%s; the lower "
              "triangle, which is all cholesky_ex reads)"
              % ((j, r0, B, -(-r0 // bc.SDIAG_K_CHUNK), err, worst, ms, pms, lms) + bnd))
        if not worst <= 1.0:
            fail("K-sdiag disagrees with its plain twin beyond the summation bound")
        if not torch.equal(bc.s_diag(buf, j, B), got):
            fail("a repeated K-sdiag gave another result")
        report["s_diag"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms, bound=bnd)

        # the panel step as the factorization takes it (the noise is in K)
        Ljj = torch.linalg.cholesky(ref).contiguous()
        inv = torch.linalg.solve_triangular(Ljj, torch.eye(B, device=dev), upper=False).contiguous()
        err, worst, untouched, _ = below_trsm_against_twin(bc, buf, inv, j, B)
        A = buf[r0 + B:, :r0]
        Kb = buf[r0 + B:, r0:r0 + B]
        Lt = buf.clone()
        ms = median_ms(lambda: bc.below_trsm(Lt, inv, j, B))
        pms = median_ms(lambda: bc.below_trsm_plain(Lt, inv, j, B))
        invT = inv.T.contiguous()
        lms = median_ms(lambda: torch.addmm(Kb, A, C.T, alpha=-1.0) @ invT)
        del Lt
        rows = m - B
        bnd = bound(4 * (rows * r0 + B * r0 + 2 * rows * B + B * B),
                    2 * rows * B * r0 + 2 * rows * B * B)
        tr = below_trsm_tile(rows)
        print("K-below-trsm j=%d (%d rows below, k=%d, row tile %d: %d blocks): max_abs_err %.3e, "
              "worst err/bound %.3f, kernel %.3f ms, plain %.3f ms, cuBLAS addmm then @ invT "
              "(two calls) %.3f ms, bound %.3f ms (%s)"
              % ((j, rows, r0, tr, rows // tr, err, worst, ms, pms, lms) + bnd))
        if not worst <= 1.0 or not untouched:
            fail("K-below-trsm disagrees with its plain twin or wrote outside column j's rows below")
        report["below_trsm"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms, bound=bnd)

        for zero_upper in (True, False):
            L1, L2 = buf.clone(), buf.clone()
            bc.col_commit(L1, Ljj, j, B, zero_upper)
            bc.col_commit_plain(L2, Ljj, j, B, zero_upper)
            err = float((L1 - L2).abs().max())
            exact = torch.equal(L1, L2)
            del L2
            ms = median_ms(lambda: bc.col_commit(L1, Ljj, j, B, zero_upper))
            pms = median_ms(lambda: bc.col_commit_plain(L1, Ljj, j, B, zero_upper))

            def library():
                L1[r0:r0 + B, r0:r0 + B].copy_(Ljj)
                if zero_upper:
                    L1[r0:r0 + B, r0 + B:].zero_()

            lms = median_ms(library)
            del L1
            bnd = bound(4 * (2 * B * B + (B * (n - r0 - B) if zero_upper else 0)), 0)
            print("K-commit j=%d zero_upper=%s: max_abs_err %.3e (exact: %s), kernel %.3f ms, "
                  "plain %.3f ms, copy_ + zero_ %.3f ms, bound %.3f ms (%s)"
                  % ((j, zero_upper, err, exact, ms, pms, lms) + bnd))
            if not exact:
                fail("K-commit is not an exact copy of its plain twin")
            entry = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms, bound=bnd)
            report["col_commit" if zero_upper else "col_commit (zero_upper=False)"] = entry
        del buf, A, Kb, C

        # K-syrk on W = L⁻¹ of the bench factor
        Lfull = torch.tril(Lfull)
        W = bt.blocked_tri_inverse(Lfull, block_size=B, invs=bt.panel_inverses(Lfull, B))
        got = bt.syrk_lower(W, B)
        ref = bt.syrk_lower_plain(W, B)
        nrm = torch.linalg.vector_norm(W, dim=0)
        err, worst = 0.0, 0.0
        for i in range(n // B):       # block row by block row: the block-lower part only
            rs, cs = slice(i * B, (i + 1) * B), slice(0, (i + 1) * B)
            d = (got[rs, cs] - ref[rs, cs]).abs()
            err = max(err, float(d.max()))
            worst = max(worst, float((d / (2 * (n + 1) * u * torch.outer(nrm[rs], nrm[cs]))).max()))
        again = bt.syrk_lower(W, B)
        same = all(torch.equal(again[i * B:(i + 1) * B, :(i + 1) * B], got[i * B:(i + 1) * B, :(i + 1) * B])
                   for i in range(n // B))
        del got, ref, again
        ms = median_ms(lambda: bt.syrk_lower(W, B), reps=5)
        # the plain twin is the port's torch.matmul row-block loop, which is
        # also the library yardstick: timed once, reported as both
        pms = lms = median_ms(lambda: bt.syrk_lower_plain(W, B), reps=5)
        # W's lower triangle read once, the block-lower output written once
        bnd = bound(4 * (n * (n + 1) // 2 + n * (n + B) // 2), syrk_ops(n, B))
        print("K-syrk n=%d, block %d: max_abs_err %.3e, worst err/bound %.3f (2(n+1)u‖W_a‖‖W_b‖), "
              "repeat bit-identical: %s, kernel %.3f ms, plain twin = library (the torch.matmul "
              "row-block loop) %.3f ms, bound %.3f ms (%s)" % ((n, B, err, worst, same, ms, pms) + bnd))
        if not worst <= 1.0 or not same:
            fail("K-syrk disagrees with its plain twin or is not bit-identical when repeated")
        report["syrk_lower"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms, bound=bnd)
        del W, Lfull

        # the whole factor, fused against unfused
        outs, times = {}, {}
        for name, fused in (("unfused (K-spanel + K-colwrite)", False),
                            ("fused (K-sdiag + K-below-trsm + K-commit)", True)):
            t = []
            for _ in range(3):
                A = K.clone()
                t.append(event_ms(lambda: bc.blocked_cholesky(A, B, fused_trsm=fused)))
            outs[fused] = torch.tril(A)
            times[name] = float(np.median(t))
            del A
        d = float((outs[True] - outs[False]).abs().max())
        print("factorization n=%d, fused against unfused: max|dL| %.3e (max|L| %.3f); %s"
              % (n, d, float(outs[False].abs().max()),
                 ", ".join("%s %.2f ms" % kv for kv in times.items())))
        if not d <= KAPPA_U * float(outs[False].abs().max()):
            fail("the fused factor is further from the unfused one than κu of its scale")
        del outs
        F, invs = bc.blocked_cholesky(K.clone(), B, fused_trsm=True, return_panel_invs=True)
        fused_by_column(bc, K, F, invs, B)
        del F, invs, K
    torch.cuda.empty_cache()
    return report


def sdiag_bound(r0, B):
    """K-sdiag's bound at r0 = j·B: its consumers (the diagonal shift and
    torch.linalg.cholesky_ex) read the lower triangle of S_jj only, so the
    function is B(B+1)/2 elements of 2·r0 flops each, reading C and K's
    lower triangle once and writing S_jj's once."""
    tri = B * (B + 1) // 2
    return bound(4 * (B * r0 + 2 * tri), 2 * tri * r0)


def sdiag_against_twin(bc, buf, j, B):
    """K-sdiag and its plain twin on buf at block column j: (the kernel's
    S_jj, max_abs_err, worst err/bound). Bound: 2·(r0+1)·u·(|C||C|ᵀ +
    |K_jj|), the summation-order bound of two float32 sums of length r0."""
    r0 = j * B
    C = buf[r0:r0 + B, :r0]
    got = bc.s_diag(buf, j, B)
    diff = (got - bc.s_diag_plain(buf, j, B)).abs()
    tol = 2 * (r0 + 1) * TWO_POW_M24 * (C.abs() @ C.abs().T + buf[r0:r0 + B, r0:r0 + B].abs())
    return got, float(diff.max()), err_over_bound(diff, tol)


def below_trsm_against_twin(bc, buf, inv, j, B):
    """K-below-trsm and its plain twin, each on its own copy of buf, at
    block column j: (max_abs_err, worst err/bound, whether the kernel wrote
    nothing outside column j's rows below, the kernel's rows). Bound: S =
    K_below − A·Cᵀ to 2·(r0+1)·u·(|A||C|ᵀ + |K_below|), carried through
    invᵀ, plus 2·(B+1)·u·|S||inv|ᵀ for the product with invᵀ."""
    import torch
    u = TWO_POW_M24
    r0 = j * B
    L1, L2 = buf.clone(), buf.clone()
    bc.below_trsm(L1, inv, j, B)
    bc.below_trsm_plain(L2, inv, j, B)
    C, A, Kb = buf[r0:r0 + B, :r0], buf[r0 + B:, :r0], buf[r0 + B:, r0:r0 + B]
    ainv = inv.abs().T
    tol = (2 * (r0 + 1) * u * (A.abs() @ C.abs().T + Kb.abs())) @ ainv \
        + 2 * (B + 1) * u * ((Kb - A @ C.T).abs() @ ainv)
    got = L1[r0 + B:, r0:r0 + B].clone()
    diff = (got - L2[r0 + B:, r0:r0 + B]).abs()
    L1[r0 + B:, r0:r0 + B] = L2[r0 + B:, r0:r0 + B]
    return float(diff.max()), err_over_bound(diff, tol), torch.equal(L1, L2), got


def err_over_bound(diff, tol):
    """max(diff / tol), an entry that is exactly right counting 0 where its
    bound is 0 too (the Gram underflows to 0 for far-apart points)."""
    import torch
    return float(torch.where(diff == 0, 0.0, diff / tol).max())


def below_trsm_tile(rows):
    """The row tile csrc/fused_trsm.cu below_trsm_f32 picks for `rows` rows
    below the diagonal block: the widest whose count fills 132 SMs once."""
    return next(4 * rpt for rpt in (8, 4, 2, 1) if rows // (4 * rpt) >= 132 or rpt == 1)


def fused_by_column(bc, K, F, invs, B):
    """Every block column j > 0 of the fused factor F of K (and invs, its
    panel inverses) held to the kernels' summation bounds: on K with F's
    left columns, K-sdiag and K-below-trsm against their twins, the
    kernels' S_jj factor and rows bit-identical to F's (the same launches on
    the same inputs), so every K-below-trsm instance (row tile 32, 16, 8, 4)
    is checked where the main path runs it. Then K-below-trsm against the
    unfused pair (K-spanel + K-colwrite) that it replaces, CUDA-event medians
    of 3 on the same buffer (their times do not depend on the values)."""
    import torch
    n = K.shape[0]
    S = torch.empty((n, B), device=K.device)
    rows, sums, worst, bad = [], [0.0, 0.0], {}, []
    if torch.triu(F, 1).any():
        bad.append("the strict upper triangle is not zero")
    for j in range(1, n // B):
        r0 = j * B
        buf = K.clone()
        buf[:, :r0] = F[:, :r0]
        Sjj, _, s_worst = sdiag_against_twin(bc, buf, j, B)
        if not s_worst <= 1.0:
            bad.append("j=%d: K-sdiag err/bound %.3f" % (j, s_worst))
        if not torch.equal(F[r0:r0 + B, r0:r0 + B], torch.linalg.cholesky_ex(Sjj)[0]):
            bad.append("j=%d: the diagonal block is not the factor of K-sdiag's S_jj" % j)
        w = worst.setdefault("K-sdiag", [0.0, []])
        w[0], w[1] = max(w[0], s_worst), w[1] + [j]
        if j == n // B - 1:       # the last column has no rows below
            break
        below = n - r0 - B
        tile = below_trsm_tile(below)
        err, t_worst, untouched, got = below_trsm_against_twin(bc, buf, invs[j], j, B)
        if not t_worst <= 1.0 or not untouched:
            bad.append("j=%d: K-below-trsm err/bound %.3f, wrote outside its rows: %s"
                       % (j, t_worst, not untouched))
        if not torch.equal(got, F[r0 + B:, r0:r0 + B]):
            bad.append("j=%d: the rows below are not K-below-trsm's on the same inputs" % j)
        w = worst.setdefault("K-below-trsm row tile %d" % tile, [0.0, []])
        w[0], w[1] = max(w[0], t_worst), w[1] + [j]
        del got
        fused = median_ms(lambda: bc.below_trsm(buf, invs[j], j, B), reps=3, warmup=1)
        unfused = median_ms(lambda: (bc.s_panel(buf, S, j, B),
                                     bc.col_write(buf, S, invs[j], invs[j], j, B, False)),
                            reps=3, warmup=1)
        sums[0] += fused
        sums[1] += unfused
        rows.append("j=%d: %d rows, tile %d, %d blocks, err/bound %.3f, %.3f vs %.3f ms"
                    % (j, below, tile, below // tile, t_worst, fused, unfused))
        del buf
    print("the fused factor by column, each kernel against its twin on the factor's own left "
          "columns (worst err/bound, columns): %s" % "; ".join(
              "%s %.3f at j=%d..%d" % (k, v[0], v[1][0], v[1][-1]) for k, v in worst.items()))
    print("K-below-trsm by column (%s) against K-spanel + K-colwrite: %s; sum %.2f ms vs %.2f ms"
          % ("row tile, blocks on 132 SMs", "; ".join(rows), sums[0], sums[1]))
    if bad:
        fail("the fused factor by column: " + "; ".join(bad))
    del S


def drive_fused_path(gpr, bm, bc, bt, fs, mg, X, Y, dev, smi):
    """Phase 20: with gpr.config.blocked_cholesky_fused_trsm and pallas_syrk
    on, the closed-form and the probe-trace steps at full width through
    gpr.train: each first step against the float64 reference of phases 7
    and 5 (the same model, data and probes) and its distance from their
    switches-off step, then three counted Adam steps. Restores both
    switches. Returns the closed-form run's launches."""
    import torch
    cfg = gpr.config
    common = {"s_panel": bc.s_panel, "col_write": bc.col_write, "s_diag": bc.s_diag,
              "below_trsm": bc.below_trsm, "col_commit": bc.col_commit,
              "syrk_lower": bt.syrk_lower, "fused_cho_solve": fs.fused_cho_solve}
    nb = X.shape[0] // 512
    fused_want = {"s_panel": (1, 1), "col_write": (1, 1), "s_diag": (nb - 1, nb - 1),
                  "below_trsm": (nb - 2, nb - 2), "col_commit": (nb - 1, nb - 1),
                  "fused_cho_solve": (1, None)}
    runs = (("closed-form", None, {"mosm_gram": mg.mosm_gram, "mosm_gram_bwd": mg.mosm_gram_bwd},
             {"mosm_gram": (1, 1), "mosm_gram_bwd": (1, 1), "syrk_lower": (1, 1)}),
            ("probe-trace", PROBES, {"mosm_gram_lower": bm.mosm_gram_sorted_lower,
                                     "mosm_lowrank_vjp": bm.mosm_lowrank_vjp_sorted},
             {"mosm_gram_lower": (1, 1), "mosm_lowrank_vjp": (1, 1), "syrk_lower": (0, 0)}))
    cfg.blocked_cholesky_fused_trsm = cfg.pallas_syrk = True
    launches = {}
    try:
        for like, probes, extra, want in runs:
            label = like + " fused"
            model = bench_model(gpr, X, Y, dev, probes)
            loss1 = check_first_step(model, bm, mg, label, like=like)
            counters = dict(common, **extra)
            launches[like] = train_and_count(gpr, model, counters, dict(fused_want, **want), loss1,
                                             label, smi)
            print("%s median step: %.2f ms with both switches on, %.2f ms off (phase %d)"
                  % (like, STEP_MS[label], STEP_MS[like], 7 if probes is None else 5))
            del model
            torch.cuda.empty_cache()
    finally:
        cfg.blocked_cholesky_fused_trsm = cfg.pallas_syrk = False
    return launches["closed-form"]


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
