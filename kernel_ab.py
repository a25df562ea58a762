#!/usr/bin/env python3
"""A/B of the MOSM Gram, blocked Cholesky, solve and low-rank VJP kernels of
two source trees on one NVIDIA GPU.

    python3 kernel_ab.py OLD_ROOT [NEW_ROOT] [--rounds N] [--only SOURCE[,SOURCE]]

Each ROOT is a checkout of this repository (for example a `git archive` of
another commit unpacked into a directory that .gitignore lists); NEW_ROOT
defaults to the directory of this script. From each root it builds
mogptk_tpu_torch/csrc/mosm_gram.cu (K-gram) and, where the root has them,
mosm_matvec.cu (K-matvec) and mosm_gram_bwd.cu (K-gram-bwd) with that
root's own headers and the nvcc flags of ops/_build.py, each into a library
of its own under NEW_ROOT/mogptk_tpu_torch/_build/ab/, and calls them in the
same process on the same inputs: the 4 x 4,096-point bench model of
chip_smoke.py (K-gram over 16,384^2, 16,384 x 4,096 and the band-lower Gram,
a root whose band-lower entry takes no tile argument taking it with band =
N for the 16,384^2 Gram, as its wrapper does; K-gram over 16,384 x 4,096 at
D = 4 on random statistics;
K-matvec at R = 33; K-gram-bwd's parameter half on a dense 16,384^2
cotangent, its unrolled instance, the closed-form step's call) and K-matvec
at benchmarks/bignum_exact.py's N = 65,536, R = 33 (a root with the fold,
mosm_matvec_fold_f32, runs its first pass and its second pass
mosm_matvec_reduce_f32; another its square-case entry mosm_matvec_f32).
From fused_trsm.cu it times K-sdiag at every block column of the bench
factor (a root with the 3xTF32 K-sdiag gets this root's sdiag_plan,
another its 512-column k chunks) and K-below-trsm at every block column
with rows below (below_trsm_cases: a root with the 3xTF32 kernel gets this
root's below_trsm_plan; with blocked_cholesky.cu also built, the unfused
K-spanel + K-colwrite pair of the same column beside it). From
family_matvec.cu (with mosm_matvec.cu's second pass) it times K-fam-matvec
for CSM and SM-LMC on the bench points at R = 33 and 1 (a root with the
fold runs its two passes, another its FFMA entry); from family_gram_bwd.cu
K-fam-gram-bwd for the same two on a dense 16,384^2 cotangent, on the
sorted points and permuted; from family_lowrank_vjp.cu K-fam-lowrank-vjp
for the same two at R = 17 and 33 (a root whose entry takes the k padding,
`int KH`, gets this root's lowrank_plan, another its own call); from
family_gram.cu K-fam-gram for the same two at 16,384^2, square on the
sorted and on permuted points (a root with the mirrored square entry
family_gram_square_f32 takes it, another its every-tile entry), and cross
at 16,384 x 4,096. With fused_trsm.cu it also times K-commit within the
fused factor (commit_cases: each block column's K-below-trsm with its
commit, the last column's K-commit alone, against a root that runs a torch
mul and a separate K-commit after K-below-trsm), and prints each round's
sum over the block columns of every per-column case. From
blocked_cholesky.cu
(with its root's headers: gemm_tile.cuh or gemm_tf32x3.cuh) it times
K-spanel at every block column of the bench factor (N = 16,384, B = 512;
one buffer holding the factor serves every column) and K-colwrite at
j = 16 in both zero_upper forms (each side on its own copy of that
buffer). A root whose K-spanel takes a split-K plan (`k_chunk`) gets this
root's ops/blocked_cholesky.spanel_plan and, where it splits, its second
pass s_panel_reduce_f32; another root gets the one-pass entry. A root
whose entries take the factor's range scale gets null (scale 1). From
fused_cho_solve.cu it times K-solve on the bench factor at R = 17, 1 and
64, and from mosm_lowrank_vjp.cu K-lowrank-vjp at N = 16,384 and 65,536
with R = 17 (solve_cases and lowrank_vjp_cases say how each root's entry
is called). From mosm_matvec.cu it also times K-gram-matvec, and from
mosm_gram_lowrank_vjp.cu K-gram-lowrank-vjp, at chip_smoke.py phase 21's
shapes on its permuted bench points (gram_matvec_cases,
gram_lowrank_vjp_cases: each root through its own entry, the split
first pass with its second pass where the root has one). --only restricts the sources built and timed. A root whose kernels
take an instance argument (`int generic`) gets 0, the unrolled instance;
K-gram-bwd's input half is off (inputs = 0). Every case runs once on
each side, checked, before the timing. Rounds
alternate which side runs first; each prints its CUDA-event medians (10
calls, 5 at N = 65,536) per case and side, then the largest difference
between the two sides' outputs and the old side's largest magnitude.
Prints the card's name and power limit first. Exits nonzero without CUDA or when a build fails.
"""
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("mosm_gram.cu", "mosm_matvec.cu", "mosm_gram_bwd.cu", "blocked_cholesky.cu",
           "fused_trsm.cu", "fused_cho_solve.cu", "mosm_lowrank_vjp.cu", "family_matvec.cu",
           "family_gram_bwd.cu", "family_lowrank_vjp.cu", "family_gram.cu",
           "mosm_gram_lowrank_vjp.cu")
# sources a library also needs where the root has them (K-gram-bwd's
# instances with the input half are compiled from a file of their own;
# K-fam-matvec's fold ends in mosm_matvec.cu's second pass)
COMPANIONS = {"mosm_gram_bwd.cu": ("mosm_gram_bwd_inputs.cu",),
              "family_matvec.cu": ("mosm_matvec.cu",)}


def takes_instance(root):
    """True when root's kernels take the instance argument `generic`."""
    with open(os.path.join(root, "mogptk_tpu_torch", "csrc", "mosm_gram.cu")) as f:
        return "int generic" in f.read()


def has(root, source, text):
    """True when root's csrc/<source> contains text."""
    with open(os.path.join(root, "mogptk_tpu_torch", "csrc", source)) as f:
        return text in f.read()


def splits_k(root):
    """True when root's K-spanel takes the split-K plan (k_chunk, part)."""
    return has(root, "blocked_cholesky.cu", "k_chunk")


def build(root, out_dir, tag, nvcc, flags, sources=SOURCES):
    """{source: ctypes library} for the sources present in root's csrc, each
    compiled by its own nvcc process, all started together."""
    csrc = os.path.join(root, "mogptk_tpu_torch", "csrc")
    procs = {}
    for src in sources:
        path = os.path.join(csrc, src)
        if not os.path.exists(path):
            continue
        lib = os.path.join(out_dir, "%s_%s.so" % (tag, src[:-3]))
        extra = [os.path.join(csrc, c) for c in COMPANIONS.get(src, ())
                 if os.path.exists(os.path.join(csrc, c))]
        cmd = [nvcc] + flags + ["-shared", "-I", csrc, path] + extra + ["-o", lib]
        procs[src] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT))
    libs = {}
    for src, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            raise RuntimeError("nvcc failed on %s of %s" % (src, root))
        regs = sorted({line.split("Used ")[1].split(",")[0] for line in log.splitlines()
                       if "Used " in line and "registers" in line})
        print("%s %s: %s" % (tag, src, ", ".join(regs)))
        libs[src] = ctypes.CDLL(lib)
    return libs


def spanel_call(lib, split, sc, Lb, S, j, B, bc, stream):
    """One K-spanel of block column j on the factor buffer Lb into S through
    lib: with its split-K plan and second pass where the root's entry takes
    one (split), else the one-pass entry; sc the range scale's argument."""
    import torch
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    n, r0 = Lb.shape[0], j * B
    splits, k_chunk = bc.spanel_plan(n, r0, B)
    part = torch.empty((splits, n - r0, B), device=Lb.device) if splits > 1 else None

    def call():
        if not split:
            return lib.s_panel_f32(P(Lb.data_ptr()), P(S.data_ptr()), I64(n), I64(r0), I64(B),
                                   P(stream))
        err = lib.s_panel_f32(P(Lb.data_ptr()), P(S.data_ptr()),
                              P(None if part is None else part.data_ptr()), I64(n), I64(r0), I64(B),
                              I64(k_chunk), *sc, P(stream))
        if err or part is None:
            return err
        return lib.s_panel_reduce_f32(P(Lb.data_ptr()), P(part.data_ptr()), P(S.data_ptr()),
                                      I64(n), I64(r0), I64(B), I64(splits), *sc, P(stream))
    return call


def scale_arg(root):
    """The range scale's argument, null (scale 1), where root's blocked
    Cholesky entries take it."""
    return [ctypes.c_void_p(None)] if has(root, "blocked_cholesky.cu", "const float* scale") else []


def cholesky_cases(libs, roots, kernel, x, c, st3, bm, bc, stream):
    """The blocked Cholesky cases: K-spanel at every block column of the
    bench factor and K-colwrite at j = 16, both zero_upper forms."""
    import torch
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    dev = x.device
    n, B = x.shape[0], 512
    counts = tuple(int(k) for k in torch.bincount(c.long(), minlength=st3.shape[0]).tolist())
    with torch.no_grad():
        K = bm.mosm_gram_sorted(x, counts, *kernel._params(), kernel.twopi)
        K.diagonal().add_(0.1)   # the bench model's noise variance
        Lb = torch.linalg.cholesky(K).contiguous()   # row-major, as the factor's buffer is
    del K
    lib = {side: libs[side]["blocked_cholesky.cu"] for side in libs}
    split = {side: splits_k(root) for side, root in roots.items()}
    sc = {side: scale_arg(root) for side, root in roots.items()}

    cases = []
    for j in range(n // B):
        plan = bc.spanel_plan(n, j * B, B)
        calls = {}
        for side in libs:
            S = torch.zeros((n, B), device=dev)
            calls[side] = (spanel_call(lib[side], split[side], sc[side], Lb, S, j, B, bc,
                                       stream), S)
        cases.append(("K-spanel j=%d (plan %dx%d)" % ((j,) + plan), "blocked_cholesky.cu", 5, calls))
    j = 16
    r0 = j * B
    S = torch.zeros((n, B), device=dev)
    S[:n - r0] = Lb[r0:, r0:r0 + B]
    Ljj = Lb[r0:r0 + B, r0:r0 + B].contiguous()
    inv = torch.linalg.solve_triangular(Ljj, torch.eye(B, device=dev), upper=False).contiguous()
    for zero_upper in (1, 0):
        calls = {}
        for side in libs:
            out = Lb.clone()
            calls[side] = ((lambda o, s: lambda: lib[s].col_write_f32(
                P(o.data_ptr()), P(S.data_ptr()), P(Ljj.data_ptr()), P(inv.data_ptr()), I64(n),
                I64(r0), I64(B), I32(zero_upper), *sc[side], P(stream)))(out, side), out)
        cases.append(("K-colwrite j=%d zero_upper=%d" % (j, zero_upper), "blocked_cholesky.cu", 10,
                      calls))
    return cases


def sdiag_cases(libs, roots, Lb, bc, stream):
    """K-sdiag at every block column j > 0 of the bench factor (N = 16,384,
    B = 512) on the factor's buffer: a root with the 3xTF32 kernel takes
    this root's sdiag_plan and null for the range scale, another its
    512-column k chunks."""
    import torch
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    n, B = Lb.shape[0], 512
    lib = {side: libs[side]["fused_trsm.cu"] for side in libs}
    tf32 = {side: has(root, "fused_trsm.cu", "gemm_tf32x3.cuh") for side, root in roots.items()}
    cases = []
    for j in range(1, n // B):
        r0 = j * B
        calls = {}
        for side in libs:
            splits = bc.sdiag_plan(r0, B) if tf32[side] else -(-r0 // 512)
            part = torch.empty((splits, B, B), device=Lb.device)
            out = torch.zeros((B, B), device=Lb.device)
            extra = [I64(splits), P(None)] if tf32[side] else [I64(512)]
            calls[side] = ((lambda l, p, o, k, e: lambda: l.s_diag_f32(
                P(Lb.data_ptr()), P(p.data_ptr()), P(o.data_ptr()), I64(n), I64(k), I64(B), *e,
                P(stream)))(lib[side], part, out, r0, extra), out)
        cases.append(("K-sdiag j=%d (plan %d)" % (j, bc.sdiag_plan(r0, B)), "fused_trsm.cu", 10,
                      calls))
    return cases


def below_trsm_cases(libs, roots, Lb, K, bc, bt, stream):
    """K-below-trsm at every block column 0 < j < n/B − 1 of the bench
    factor Lb of K (N = 16,384, B = 512), the panel inverses of the
    factor's own diagonal blocks: a root whose kernel runs on the 3xTF32 mainloop (its
    entry takes the scratch strip S) gets this root's below_trsm_plan, scratch and
    null for the range scale, another its FFMA entry. The kernel writes the
    rows below column j's diagonal block in place, reading them first as K,
    so each call first restores them from K (a copy of at most 31 MB, in
    both sides' times); each side has its own buffer, which holds the
    factor's columns, so the outputs (the factor's rows below) compare at
    rounding level. Where both roots have
    blocked_cholesky.cu, beside each column the unfused pair it replaces:
    K-spanel over the column's n − j·B rows, then K-colwrite (zero_upper=0)
    into a buffer of its own, each side its root's pair."""
    import torch
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    n, B = Lb.shape[0], 512
    dev = Lb.device
    invs = bt.panel_inverses(Lb, block_size=B)
    mainloop = {side: has(root, "fused_trsm.cu", "below_trsm_f32(float* L, const float* inv, float* S")
                for side, root in roots.items()}
    commit = {side: commit_arg(root) for side, root in roots.items()}
    pair = all("blocked_cholesky.cu" in l for l in libs.values())
    bufs = {side: Lb.clone() for side in libs}
    outs = {side: Lb.clone() for side in libs} if pair else {}
    cases = []
    for j in range(1, n // B - 1):
        r0 = j * B
        m = n - r0 - B
        splits, k_chunk = bc.below_trsm_plan(n, r0, B)
        inv = invs[j]
        calls = {}
        for side in libs:
            lib = libs[side]["fused_trsm.cu"]
            rows = bufs[side][r0 + B:, r0:r0 + B]
            S = torch.empty((m, B), device=dev)
            part = torch.empty((splits, m, B), device=dev) if splits > 1 else None

            def call(lib=lib, buf=bufs[side], rows=rows, S=S, part=part, tc=mainloop[side], r0=r0,
                     inv=inv, k_chunk=k_chunk, cm=commit[side]):
                rows.copy_(K[r0 + B:, r0:r0 + B])
                if not tc:
                    return lib.below_trsm_f32(P(buf.data_ptr()), P(inv.data_ptr()), I64(n),
                                              I64(r0), I64(B), P(stream))
                ljj, zu = ([P(None)], [I32(0)]) if cm else ([], [])
                return lib.below_trsm_f32(P(buf.data_ptr()), P(inv.data_ptr()), P(S.data_ptr()),
                                          P(None if part is None else part.data_ptr()), *ljj,
                                          I64(n), I64(r0), I64(B), I64(k_chunk), *zu, P(None),
                                          P(stream))
            calls[side] = (call, rows)
        cases.append(("K-below-trsm j=%d (plan %dx%d)" % (j, splits, k_chunk), "fused_trsm.cu", 5,
                      calls))
        if not pair:
            continue
        Ljj = Lb[r0:r0 + B, r0:r0 + B].contiguous()
        calls = {}
        for side, root in roots.items():
            lib = libs[side]["blocked_cholesky.cu"]
            S = torch.empty((n, B), device=dev)
            spanel = spanel_call(lib, splits_k(root), scale_arg(root), Lb, S, j, B, bc, stream)
            rows = outs[side][r0 + B:, r0:r0 + B]

            def call(lib=lib, S=S, spanel=spanel, out=outs[side], sc=scale_arg(root), r0=r0,
                     inv=inv, Ljj=Ljj):
                return spanel() or lib.col_write_f32(
                    P(out.data_ptr()), P(S.data_ptr()), P(Ljj.data_ptr()), P(inv.data_ptr()),
                    I64(n), I64(r0), I64(B), I32(0), *sc, P(stream))
            calls[side] = (call, rows)
        cases.append(("K-spanel + K-colwrite j=%d (the unfused pair)" % j, "fused_trsm.cu", 5,
                      calls))
    return cases


def commit_arg(root):
    """True when root's K-below-trsm takes the diagonal block to commit in
    its TRSM launch (COMMIT_ROWS rows a CTA); its K-commit then takes the
    range scale."""
    return has(root, "fused_trsm.cu", "COMMIT_ROWS")


def commit_cases(libs, roots, Lb, K, bc, bt, stream):
    """K-commit within the fused factor, block column by block column of the
    bench factor Lb of K (N = 16,384, B = 512, zero_upper off as the
    training factor has it), on the factor's diagonal blocks and panel
    inverses with the factor's range scale: a root whose K-below-trsm
    commits in its TRSM launch runs, for j < n/B − 1, that launch with Ljj
    and, for the last column, K-commit with the scale; another root runs
    K-below-trsm, the torch mul Ljj·(1/r) and K-commit, as its fused loop
    did. Each call first restores column j's rows below from K (in both
    sides' times)."""
    import torch
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    n, B = Lb.shape[0], 512
    nb, dev = n // B, Lb.device
    invs = bt.panel_inverses(Lb, block_size=B)
    scale = bc.range_scale(K.diagonal())
    bufs = {side: Lb.clone() for side in libs}
    cases = []
    for j in range(1, nb):
        r0 = j * B
        m = n - r0 - B
        splits, k_chunk = bc.below_trsm_plan(n, r0, B) if m else (1, B)
        Ljj = Lb[r0:r0 + B, r0:r0 + B].contiguous()
        calls = {}
        for side, root in roots.items():
            lib = libs[side]["fused_trsm.cu"]
            new = commit_arg(root)
            S = torch.empty((max(m, 1), B), device=dev)
            part = torch.empty((splits, m, B), device=dev) if splits > 1 else None

            def call(lib=lib, buf=bufs[side], S=S, part=part, r0=r0, m=m, j=j, Ljj=Ljj,
                     k_chunk=k_chunk, new=new):
                buf[r0 + B:, r0:r0 + B].copy_(K[r0 + B:, r0:r0 + B])
                if m:
                    tail = [P(Ljj.data_ptr())] if new else []
                    err = lib.below_trsm_f32(
                        P(buf.data_ptr()), P(invs[j].data_ptr()), P(S.data_ptr()),
                        P(None if part is None else part.data_ptr()), *tail, I64(n), I64(r0),
                        I64(B), I64(k_chunk), *([I32(0)] if new else []), P(scale.data_ptr()),
                        P(stream))
                    if err or new:
                        return err
                if new:
                    return lib.col_commit_f32(P(buf.data_ptr()), P(Ljj.data_ptr()), I64(n),
                                              I64(r0), I64(B), I32(0), P(scale.data_ptr()),
                                              P(stream))
                Lu = Ljj * scale[2]
                return lib.col_commit_f32(P(buf.data_ptr()), P(Lu.data_ptr()), I64(n), I64(r0),
                                          I64(B), I32(0), P(stream))
            calls[side] = (call, bufs[side][r0:, r0:r0 + B])
        cases.append(("fused column (K-below-trsm + K-commit) j=%d" % j, "fused_trsm.cu", 5,
                      calls))
    return cases


def family_gram_cases(libs, roots, gpr, cs, X, stream):
    """K-fam-gram for CSM and SM-LMC on the bench points (N = 16,384): the
    square Gram on the channel-sorted points and on the same points
    permuted (a root with the square entry family_gram_square_f32 takes it,
    another its every-tile entry on x against itself), and the cross Gram
    against every fourth point (16,384 x 4,096, predict's block)."""
    import numpy as np
    import torch
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    dev = X.device
    perm = torch.as_tensor(np.random.RandomState(5).permutation(X.shape[0]), device=dev)
    cases = []
    for name, _, x, c, table, counts, fam, A, S in family_bench_kernels(gpr, cs, X):
        n, D = x.shape
        O = len(counts)
        xq, cq = x[::4].contiguous(), c[::4].contiguous()
        for how, x1, c1, x2, c2 in (("square sorted", x, c, x, c),
                                    ("square permuted", x[perm].contiguous(),
                                     c[perm].contiguous(), None, None),
                                    ("cross", x, c, xq, cq)):
            x2, c2 = (x1, c1) if x2 is None else (x2, c2)
            m = x2.shape[0]
            calls = {}
            for side, root in roots.items():
                lib = libs[side]["family_gram.cu"]
                out = torch.empty((n, m), device=dev)
                keep = (x1, c1, x2, c2, table)
                if x2 is x1 and has(root, "family_gram.cu", "family_gram_square_f32"):
                    args = (P(x1.data_ptr()), P(c1.data_ptr()), P(table.data_ptr()),
                            P(out.data_ptr()), I64(n), I32(O), I32(S), I32(D), I32(A), I32(fam),
                            P(stream))
                    calls[side] = (thunk(lib.family_gram_square_f32, args, keep), out)
                else:
                    args = (P(x1.data_ptr()), P(c1.data_ptr()), P(x2.data_ptr()),
                            P(c2.data_ptr()), P(table.data_ptr()), P(out.data_ptr()), I64(n),
                            I64(m), I32(O), I32(S), I32(D), I32(A), I32(fam), P(stream))
                    calls[side] = (thunk(lib.family_gram_f32, args, keep), out)
            cases.append(("K-fam-gram %s %s %dx%d" % (name, how, n, m), "family_gram.cu", 10,
                          calls))
    return cases


def fam_call(lib, fold, x, c, table, V, out, items, part, nb, O, S, A, fam, stream):
    """One K-fam-matvec call through lib: the fold's two passes, or the FFMA
    entry of a root without the fold."""
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    (n, D), R = x.shape, V.shape[1]
    if not fold:
        return lambda: lib.family_matvec_f32(
            P(x.data_ptr()), P(c.data_ptr()), P(table.data_ptr()), P(V.data_ptr()),
            P(out.data_ptr()), I64(n), I32(R), I32(O), I32(S), I32(D), I32(A), I32(fam), P(stream))
    return lambda: lib.family_matvec_fold_f32(
        P(x.data_ptr()), P(c.data_ptr()), P(table.data_ptr()), P(V.data_ptr()),
        P(items.data_ptr()), I64(items.shape[0]), P(part.data_ptr()), I64(n), I32(R), I32(nb),
        I32(O), I32(S), I32(D), I32(A), I32(fam), P(stream)) or lib.mosm_matvec_reduce_f32(
            P(part.data_ptr()), P(out.data_ptr()), I64(n), I32(R), P(stream))


def family_matvec_cases(libs, roots, gpr, cs, X, stream):
    """K-fam-matvec for CSM and SM-LMC (family_bench_kernels) at R = 33 and
    1: a root with the fold (family_matvec_fold_f32) runs its first pass and
    the second pass mosm_matvec_reduce_f32 (mosm_matvec.cu, built into the
    same library), another its FFMA entry family_matvec_f32."""
    import torch
    from mogptk_tpu_torch.ops import mosm_matvec as mv
    dev = X.device
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = []
    for name, _, x, c, table, counts, fam, A, S in family_bench_kernels(gpr, cs, X):
        n, O = x.shape[0], len(counts)
        for R in (33, 1):
            V = torch.randn((n, R), generator=gen, device=dev)
            nb, _ = mv.fold_group(n, R)
            items = mv.fold_items_on(n, dev)
            part = torch.empty((mv.fold_slab_base(*mv.fold_tiles(n)) * mv.FOLD_TILE, R), device=dev)
            calls = {}
            for side, root in roots.items():
                out = torch.empty((n, R), device=dev)
                fold = has(root, "family_matvec.cu", "family_matvec_fold_f32")
                calls[side] = (fam_call(libs[side]["family_matvec.cu"], fold, x, c, table, V, out,
                                        items, part, nb, O, S, A, fam, stream), out)
            cases.append(("K-fam-matvec %s N=%d R=%d" % (name, n, R), "family_matvec.cu", 10,
                          calls))
    return cases


def thunk(f, args, keep):
    """A call of f(*args) that holds `keep`, the tensors args point into."""
    return lambda: (keep, f(*args))[1]


def family_bench_kernels(gpr, cs, X):
    """(name, family, x, c, table, counts, fam, A, S) for CSM and SM-LMC,
    chip_smoke.py's phase 18 kernels (family_kernel at bench width), on the
    bench points (N = 16,384, channel-sorted)."""
    import torch
    from mogptk_tpu_torch.ops import block_families as bf
    out = []
    for name in ("csm", "lmc_sm"):
        kernel = cs.family_kernel(gpr, name, channels=cs.CHANNELS).to(X.device)
        c, x = kernel._split(X)
        with torch.no_grad():
            pack = bf.family_pack(kernel.family, kernel._fused_params())
        fam, A, S = bf.family_dims(kernel.family, pack, x.shape[1])
        O = pack.shape[0]
        counts = tuple(int(k) for k in torch.bincount(c.long(), minlength=O).tolist())
        out.append((name, kernel.family, x, c, pack.reshape(O * O, S).contiguous(), counts, fam,
                    A, S))
    return out


def family_gram_bwd_cases(libs, roots, gpr, cs, X, stream):
    """K-fam-gram-bwd for CSM and SM-LMC on a dense 16,384^2 cotangent, the
    closed-form step's call: on the bench points (channels of 4,096 rows,
    so the maps are the identity and g is read in place) and on the same
    points permuted (the maps gather)."""
    import numpy as np
    import torch
    from mogptk_tpu_torch.ops import mosm_gram as mg
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    dev = X.device
    gen = torch.Generator(device=dev).manual_seed(6)
    g = torch.randn((X.shape[0], X.shape[0]), generator=gen, device=dev)
    perm = torch.as_tensor(np.random.RandomState(5).permutation(X.shape[0]), device=dev)
    cases = []
    for name, _, x, c, table, counts, fam, A, S in family_bench_kernels(gpr, cs, X):
        n, D = x.shape
        idx, pairs = mg._device_gram_layout(counts, counts, mg.BWD_TILE, dev)
        for how, xx, cc in (("sorted", x, c), ("permuted", x[perm].contiguous(),
                                                 c[perm].contiguous())):
            rmap = mg.channel_map(cc, counts)
            calls = {}
            for side in roots:
                partial = torch.empty((4 * idx.shape[0], S), device=dev)
                out = torch.zeros((len(counts) ** 2, S), device=dev)
                args = (P(idx.data_ptr()), P(g.data_ptr()), P(xx.data_ptr()), P(rmap.data_ptr()),
                        P(xx.data_ptr()), P(rmap.data_ptr()), P(table.data_ptr()),
                        P(partial.data_ptr()), P(pairs.data_ptr()), P(out.data_ptr()),
                        I32(idx.shape[0]), I32(pairs.shape[0]), I64(n), I32(S), I32(D), I32(A),
                        I32(fam), P(stream))
                calls[side] = (thunk(libs[side]["family_gram_bwd.cu"].family_gram_bwd_f32, args,
                                     (g, xx, rmap, partial, idx, pairs, table)), out)
            cases.append(("K-fam-gram-bwd %s %s %dx%d" % (name, how, n, n), "family_gram_bwd.cu",
                          10, calls))
    return cases


def family_lowrank_vjp_cases(libs, roots, gpr, cs, X, stream):
    """K-fam-lowrank-vjp for CSM and SM-LMC on the bench points (N = 16,384)
    at R = 17 (the probe-trace step) and 33 (the iterative step). A root
    whose entry takes the k padding (`int KH`) gets this root's
    lowrank_plan; another its chunk alone."""
    import torch
    from mogptk_tpu_torch.ops import block_mosm as bm
    P, I32 = ctypes.c_void_p, ctypes.c_int
    dev = X.device
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = []
    for name, _, x, c, table, counts, fam, A, S in family_bench_kernels(gpr, cs, X):
        n, D = x.shape
        idx, pairs = bm._device_layout(counts, bm.BWD_TILE, dev)
        for R in (17, 33):
            Am = 1e-2 * torch.randn((n, R), generator=gen, device=dev)
            Bm = torch.randn((n, R), generator=gen, device=dev)
            RC, KH = bm.lowrank_plan(R)
            calls = {}
            for side, root in roots.items():
                partial = torch.empty((4 * idx.shape[0], S), device=dev)
                out = torch.zeros((len(counts) ** 2, S), device=dev)
                kh = [I32(KH)] if has(root, "family_lowrank_vjp.cu", "int KH") else []
                args = (P(idx.data_ptr()), P(x.data_ptr()), P(Am.data_ptr()), P(Bm.data_ptr()),
                        P(table.data_ptr()), P(partial.data_ptr()), P(pairs.data_ptr()),
                        P(out.data_ptr()), I32(idx.shape[0]), I32(pairs.shape[0]), I32(R),
                        I32(RC), *kh, I32(S), I32(D), I32(A), I32(fam), P(stream))
                calls[side] = (thunk(libs[side]["family_lowrank_vjp.cu"].family_lowrank_vjp_f32,
                                     args, (x, Am, Bm, partial, idx, pairs, table)), out)
            cases.append(("K-fam-lowrank-vjp %s N=%d R=%d (%d tiles)" % (name, n, R, idx.shape[0]),
                          "family_lowrank_vjp.cu", 10, calls))
    return cases


def solve_cases(libs, roots, Lb, bt, stream):
    """K-solve on the bench factor (N = 16,384, B = 512) with R = 17 (the
    probe-trace step's y and 16 probes), 1 and 64: a root with the persistent
    kernel (`int* counts`) gets a zeroed count tensor each call, another its
    launch-per-step entry, which overwrites its right-hand side (copied in
    each call)."""
    import torch
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    n, B = Lb.shape[0], 512
    nb = n // B
    invs = bt.panel_inverses(Lb, block_size=B)
    gen = torch.Generator(device=Lb.device).manual_seed(3)
    persistent = {side: has(root, "fused_cho_solve.cu", "int* counts")
                  for side, root in roots.items()}
    cases = []
    for R in (17, 1, 64):
        rhs = torch.randn((n, R), generator=gen, device=Lb.device)
        calls = {}
        for side in libs:
            lib = libs[side]["fused_cho_solve.cu"]
            V, Z, X = (torch.empty_like(rhs) for _ in range(3))
            if persistent[side]:
                counts = torch.zeros(1 + 4 * nb, dtype=torch.int32, device=Lb.device)
                # v, z and x in rows of the kernel's stride
                zs = lib.fused_cho_solve_rhs_stride(I32(R))
                V, Z, Xp = torch.empty((3, n, zs), device=Lb.device)
                call = (lambda l, rhs, V, Z, Xp, X, counts: lambda: (
                    counts.zero_(), l.fused_cho_solve_f32(
                        P(Lb.data_ptr()), P(invs.data_ptr()), P(rhs.data_ptr()), P(V.data_ptr()),
                        P(Z.data_ptr()), P(Xp.data_ptr()), P(X.data_ptr()), P(counts.data_ptr()),
                        I64(n), I64(B), I32(rhs.shape[1]), I32(0), P(stream)))[1])(
                            lib, rhs, V, Z, Xp, X, counts)
            else:
                call = (lambda l, rhs, V, Z, X: lambda: (V.copy_(rhs), l.fused_cho_solve_f32(
                    P(Lb.data_ptr()), P(invs.data_ptr()), P(V.data_ptr()), P(Z.data_ptr()),
                    P(X.data_ptr()), I64(n), I64(B), I32(rhs.shape[1]), P(stream)))[1])(
                        lib, rhs, V, Z, X)
            calls[side] = (call, X)
        cases.append(("K-solve N=%d B=%d R=%d" % (n, B, R), "fused_cho_solve.cu", 10, calls))
    return cases


def lowrank_vjp_cases(libs, roots, points, stats, Q, D, stream):
    """K-lowrank-vjp at the probe-trace step's shape (N = 16,384) and the
    iterative step's (N = 65,536), R = 17: points is a list of channel-sorted
    (x, counts) whose channels are multiples of 256 rows. A root whose entry
    takes the k padding (`int KH`) gets this root's lowrank_kpad."""
    import torch
    from mogptk_tpu_torch.ops import block_mosm as bm
    P, I32 = ctypes.c_void_p, ctypes.c_int
    cases = []
    for x, counts in points:
        n, R = x.shape[0], 17
        gen = torch.Generator(device=x.device).manual_seed(4)
        A = 1e-2 * torch.randn((n, R), generator=gen, device=x.device)
        Bm = torch.randn((n, R), generator=gen, device=x.device)
        idx, pairs = bm._device_layout(counts, bm.BWD_TILE, x.device)
        nout = 3 * Q * D + 2 * Q
        RC = bm.lowrank_chunk(R)
        calls = {}
        for side, root in roots.items():
            lib = libs[side]["mosm_lowrank_vjp.cu"]
            partial = torch.empty((4 * idx.shape[0], nout), device=x.device)
            out = torch.zeros((len(counts) ** 2, nout), device=x.device)
            kh = [I32(bm.lowrank_kpad(RC))] if has(root, "mosm_lowrank_vjp.cu", "int KH") else []
            calls[side] = ((lambda l, x, A, Bm, idx, pairs, partial, out, kh: lambda: (
                l.mosm_lowrank_vjp_f32(
                    P(idx.data_ptr()), P(x.data_ptr()), P(A.data_ptr()), P(Bm.data_ptr()),
                    P(stats.data_ptr()), P(partial.data_ptr()), P(pairs.data_ptr()),
                    P(out.data_ptr()), I32(idx.shape[0]), I32(pairs.shape[0]), I32(Q), I32(D),
                    I32(R), I32(RC), *kh, I32(0), P(stream))))(
                        lib, x, A, Bm, idx, pairs, partial, out, kh), out)
        cases.append(("K-lowrank-vjp N=%d R=%d (%d tiles)" % (n, R, idx.shape[0]),
                      "mosm_lowrank_vjp.cu", 10 if n <= 16384 else 5, calls))
    return cases


def phase21_points(cs, kernel, x, c):
    """Phase 21's point sets: the bench points permuted (the seed of
    chip_smoke.py's phase 21), the 4,096 request points (b) and the 1,024
    (a), each (x, c) contiguous on x's device."""
    import numpy as np
    import torch
    perm = torch.as_tensor(np.random.RandomState(21).permutation(x.shape[0]), device=x.device)
    reqs = {k: torch.as_tensor(v, dtype=torch.float32, device=x.device)
            for k, v in cs.requests().items()}
    out = {"x": (x[perm].contiguous(), c[perm].contiguous())}
    for name in ("a", "b"):
        cq, xq = kernel._split(reqs[name])
        out[name] = (xq.contiguous(), cq.contiguous())
    return out


def gram_matvec_cases(libs, roots, pts, stats, O, Q, D, stream):
    """K-gram-matvec at phase 21's shapes: K(X, X)·V on the bench points
    permuted with R = 1, 33 and 1,024, and K(Xq, X)·V with the 4,096
    request points, R = 33. A root with the split first pass (its second
    pass mosm_gram_matvec_reduce_f32) runs this root's gram_matvec_plan and,
    where the plan splits the columns, the second pass; another root its
    one-launch entry."""
    import torch
    from mogptk_tpu_torch.ops import mosm_matvec as mv
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    xp, cp = pts["x"]
    xq, cq = pts["b"]
    gen = torch.Generator(device=xp.device).manual_seed(21)
    cases = []
    for (x1, c1), R in (((xp, cp), 1), ((xp, cp), 33), ((xp, cp), 1024), ((xq, cq), 33)):
        N, M = x1.shape[0], xp.shape[0]
        V = torch.randn((M, R), generator=gen, device=xp.device)
        calls = {}
        for side, root in roots.items():
            lib = libs[side]["mosm_matvec.cu"]
            out = torch.empty((N, R), device=xp.device)
            head = [P(t.data_ptr()) for t in (x1, c1, xp, cp, stats, V)]
            keep = (x1, c1, V, out)
            if not has(root, "mosm_matvec.cu", "mosm_gram_matvec_reduce_f32"):
                calls[side] = (thunk(lib.mosm_gram_matvec_f32, head + [
                    P(out.data_ptr()), I64(N), I64(M), I32(R), I32(O), I32(Q), I32(D), I32(0),
                    P(stream)], keep), out)
                continue
            nb, splits, tps = mv.gram_matvec_plan(N, M, R, mv.sm_count(xp.device))
            part = out if splits == 1 else torch.empty((splits, N, R), device=xp.device)
            first = thunk(lib.mosm_gram_matvec_f32, head + [
                P(part.data_ptr()), I64(N), I64(M), I32(R), I32(O), I32(Q), I32(D), I32(nb),
                I32(tps), I32(0), P(stream)], keep + (part,))
            second = thunk(lib.mosm_gram_matvec_reduce_f32, [
                P(part.data_ptr()), P(out.data_ptr()), I64(N), I32(R), I32(splits), P(stream)],
                keep + (part,))
            calls[side] = ((lambda first, second, splits: lambda: first() or (
                second() if splits > 1 else 0))(first, second, splits), out)
        cases.append(("K-gram-matvec %dx%d R=%d" % (N, M, R), "mosm_matvec.cu", 10, calls))
    return cases


def gram_lowrank_vjp_cases(libs, roots, pts, stats, O, Q, D, stream):
    """K-gram-lowrank-vjp at phase 21's shapes: the bench points permuted
    against themselves (16,384², R = 17 and 65) and the 1,024 request points
    against them (Kuf, R = 17), the channel maps and the tile list as its
    wrapper builds them. A root whose entry takes the k padding (`int KH`)
    gets this root's lowrank_plan, another its chunk alone."""
    import torch
    from mogptk_tpu_torch.ops import block_mosm as bm, mosm_gram as mg
    P, I32 = ctypes.c_void_p, ctypes.c_int
    xp, cp = pts["x"]
    xu, cu = pts["a"]
    gen = torch.Generator(device=xp.device).manual_seed(17)
    nout = 3 * Q * D + 2 * Q
    cases = []
    for (x1, c1), R in (((xp, cp), 17), ((xp, cp), 65), ((xu, cu), 17)):
        N = x1.shape[0]
        A = torch.randn((N, R), generator=gen, device=xp.device)
        B = torch.randn((xp.shape[0], R), generator=gen, device=xp.device)
        counts1, counts2 = mg.channel_counts(c1, O), mg.channel_counts(cp, O)
        rmap, cmap = mg.channel_map(c1, counts1), mg.channel_map(cp, counts2)
        idx, pairs = mg._device_gram_layout(counts1, counts2, bm.BWD_TILE, xp.device)
        RC, KH = bm.lowrank_plan(R)
        calls = {}
        for side, root in roots.items():
            lib = libs[side]["mosm_gram_lowrank_vjp.cu"]
            partial = torch.empty((4 * idx.shape[0], nout), device=xp.device)
            out = torch.zeros((O * O, nout), device=xp.device)
            kh = [I32(KH)] if has(root, "mosm_gram_lowrank_vjp.cu", "int KH") else []
            args = [P(t.data_ptr()) for t in (idx, x1, rmap, xp, cmap, A, B, stats, partial,
                                               pairs, out)]
            calls[side] = (thunk(lib.mosm_gram_lowrank_vjp_f32, args + [
                I32(idx.shape[0]), I32(pairs.shape[0]), I32(Q), I32(D), I32(R), I32(RC), *kh,
                I32(0), P(stream)], (idx, x1, rmap, cmap, A, B, partial, pairs, out)), out)
        cases.append(("K-gram-lowrank-vjp %dx%d R=%d (%d tiles)"
                      % (N, xp.shape[0], R, idx.shape[0]), "mosm_gram_lowrank_vjp.cu", 10, calls))
    return cases


def main():
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    rounds = 4
    if "--rounds" in sys.argv:
        rounds = int(sys.argv[sys.argv.index("--rounds") + 1])
        args.remove(str(rounds))
    only = SOURCES
    if "--only" in sys.argv:
        only = tuple(sys.argv[sys.argv.index("--only") + 1].split(","))
        args.remove(",".join(only))
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"old": os.path.abspath(args[0]),
             "new": os.path.abspath(args[1]) if len(args) > 1 else HERE}
    sys.path.insert(0, roots["new"])
    import chip_smoke as cs
    import mogptk_tpu_torch.gpr as gpr
    from mogptk_tpu_torch.ops import _build, block_mosm as bm, blocked_cholesky as bc
    from mogptk_tpu_torch.ops import mosm_gram as mg, mosm_matvec as mv

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    out_dir = os.path.join(roots["new"], "mogptk_tpu_torch", "_build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    libs = {side: build(root, out_dir, side, _build.nvcc_path(), list(_build.NVCC_FLAGS), only)
            for side, root in roots.items()}

    dev = "cuda"
    xs, ys = cs.make_data()
    _, X, _ = gpr.merge_data(xs, ys, device=dev)
    kernel = gpr.MultiOutputSpectralMixtureKernel(cs.Q, output_dims=cs.CHANNELS)
    cs.set_bench_params(kernel)
    kernel.to(dev)
    bx, by, _, _ = cs.make_bignum_data()
    _, Xb, _ = gpr.merge_data(bx, by, device=dev)
    with torch.no_grad():
        st3, st2 = bm.mosm_pair_stats(*kernel._params(), kernel.twopi)
        stats = mg.stats_table(st3, st2)
        c, x = kernel._split(X)
        cb, xb = kernel._split(Xb)
    x, c, xb, cb = x.contiguous(), c.contiguous(), xb.contiguous(), cb.contiguous()
    xq, cq = x[::4].contiguous(), c[::4].contiguous()
    n, nb = x.shape[0], xb.shape[0]
    O, Q, D = st3.shape[0], st3.shape[2], st3.shape[3]
    gen = torch.Generator(device=dev).manual_seed(0)
    V, Vb = (torch.randn((m, 33), generator=gen, device=dev) for m in (n, nb))
    stream = torch.cuda.current_stream().cuda_stream
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    inst = {side: [I32(0)] if takes_instance(root) else [] for side, root in roots.items()}
    side_of = {id(lib): side for side in libs for lib in libs[side].values()}

    def ptr(t):
        return P(t.data_ptr())

    def lower_takes_tile(side):
        return has(roots[side], "mosm_gram.cu", "int64_t tile, int64_t band")

    def gram(lib, out, x2, c2):
        side = side_of[id(lib)]
        tail = inst[side] + [P(stream)]
        if x2 is x and not lower_takes_tile(side):   # the square call: band = N
            return lambda: lib.mosm_gram_lower_f32(ptr(x), ptr(c), ptr(stats), ptr(out), I64(n),
                                                   I32(O), I32(Q), I32(D), I64(n), *tail)
        return lambda: lib.mosm_gram_f32(ptr(x), ptr(c), ptr(x2), ptr(c2), ptr(stats), ptr(out),
                                         I64(n), I64(x2.shape[0]), I32(O), I32(Q), I32(D), *tail)

    def lower(lib, out):
        side = side_of[id(lib)]
        tile = [I64(bm.TILE)] if lower_takes_tile(side) else []
        return lambda: lib.mosm_gram_lower_f32(ptr(x), ptr(c), ptr(stats), ptr(out), I64(n),
                                               I32(O), I32(Q), I32(D), *tile, I64(512),
                                               *inst[side], P(stream))

    # K-gram at D = 4 on random pair statistics
    gen4 = torch.Generator(device=dev).manual_seed(4)
    D4 = 4
    x4 = torch.cat([x * s for s in (1.0, 0.8, 0.6, 0.4)], 1).contiguous()
    xq4 = x4[::4].contiguous()
    params4 = [0.5 + torch.rand((O, Q), generator=gen4, device=dev)] + [
        lo + sc * torch.rand((O, Q, D4), generator=gen4, device=dev)
        for lo, sc in ((0.1, 1.0), (0.2, 1.0), (-0.05, 0.1))] + [
        0.1 * torch.randn((O, Q), generator=gen4, device=dev)]
    stats4 = mg.stats_table(*bm.mosm_pair_stats(*params4, (2 * torch.pi) ** (D4 / 2)))

    def gram4(lib, out):
        tail = inst[side_of[id(lib)]] + [P(stream)]
        return lambda: lib.mosm_gram_f32(ptr(x4), ptr(c), ptr(xq4), ptr(cq), ptr(stats4),
                                         ptr(out), I64(n), I64(xq4.shape[0]), I32(O), I32(Q),
                                         I32(D4), *tail)

    def matvec(lib, out, xx, cc, VV):
        side = side_of[id(lib)]
        tail = inst[side] + [P(stream)]
        N, R = xx.shape[0], VV.shape[1]
        if not has(roots[side], "mosm_matvec.cu", "mosm_matvec_fold_f32"):
            return lambda: lib.mosm_matvec_f32(ptr(xx), ptr(cc), ptr(stats), ptr(VV), ptr(out),
                                               I64(N), I32(R), I32(O), I32(Q), I32(D), *tail)
        nb, _ = mv.fold_group(N, R)
        items = torch.as_tensor(mv.fold_items(N), device=dev)
        part = torch.empty((mv.fold_slab_base(*mv.fold_tiles(N)) * mv.FOLD_TILE, R), device=dev)

        def call():
            err = lib.mosm_matvec_fold_f32(ptr(xx), ptr(cc), ptr(stats), ptr(VV), ptr(items),
                                           I64(items.shape[0]), ptr(part), I64(N), I32(R),
                                           I32(nb), I32(O), I32(Q), I32(D), *tail)
            return err or lib.mosm_matvec_reduce_f32(ptr(part), ptr(out), I64(N), I32(R),
                                                     P(stream))
        return call

    # K-gram-bwd on the bench model's sorted Gram: channels of 4,096 rows,
    # so the maps are the identity and g is read in place
    counts = tuple(int(k) for k in torch.bincount(c.long(), minlength=O).tolist())
    idx, pairs = mg._device_gram_layout(counts, counts, mg.BWD_TILE, torch.device(dev))
    rmap = mg.channel_map(c, counts)
    g = torch.randn((n, n), generator=gen, device=dev)
    nout = 3 * Q * D + 2 * Q
    partial = torch.empty((4 * idx.shape[0], nout), device=dev)

    def gram_bwd(lib, out):
        new = inst[side_of[id(lib)]]
        extra = ([I32(0), I32(0), P(0), P(0), P(0), I32(0), I32(0), P(0), P(0)] if new else [])
        return lambda: lib.mosm_gram_bwd_f32(
            ptr(idx), ptr(g), ptr(x), ptr(rmap), ptr(x), ptr(rmap), ptr(stats), ptr(partial),
            ptr(pairs), ptr(out), I32(idx.shape[0]), I32(pairs.shape[0]), I64(n), I32(Q), I32(D),
            *extra, P(stream))

    cases = []   # (name, source, reps, {side: (call, output)})
    if all("blocked_cholesky.cu" in l for l in libs.values()):
        cases += cholesky_cases(libs, roots, kernel, x, c, st3, bm, bc, stream)
    built = {src for src in SOURCES if all(src in l for l in libs.values())}
    if built & {"fused_trsm.cu", "fused_cho_solve.cu"}:
        counts = tuple(int(k) for k in torch.bincount(c.long(), minlength=O).tolist())
        with torch.no_grad():
            Kb = bm.mosm_gram_sorted(x, counts, *kernel._params(), kernel.twopi)
            Kb.diagonal().add_(0.1)   # the bench model's noise variance
            Lb = torch.linalg.cholesky(Kb).contiguous()   # row-major, as the factor's buffer is
        if "fused_trsm.cu" in built:
            from mogptk_tpu_torch.ops import blocked_trisolve as bt
            cases += sdiag_cases(libs, roots, Lb, bc, stream)
            cases += below_trsm_cases(libs, roots, Lb, Kb, bc, bt, stream)
            cases += commit_cases(libs, roots, Lb, Kb, bc, bt, stream)
        del Kb
        if "fused_cho_solve.cu" in built:
            from mogptk_tpu_torch.ops import blocked_trisolve as bt
            cases += solve_cases(libs, roots, Lb, bt, stream)
    if "mosm_lowrank_vjp.cu" in built:
        points = [(xx, tuple(int(k) for k in torch.bincount(cc.long(), minlength=O).tolist()))
                  for xx, cc in ((x, c), (xb, cb))]
        cases += lowrank_vjp_cases(libs, roots, points, stats, Q, D, stream)
    gram_cases = (("K-gram %dx%d" % (n, n), (n, n), lambda lib, o: gram(lib, o, x, c)),
                  ("K-gram %dx%d" % (n, xq.shape[0]), (n, xq.shape[0]),
                   lambda lib, o: gram(lib, o, xq, cq)),
                  ("K-gram-lower %dx%d band 512" % (n, n), (n, n), lower),
                  ("K-gram %dx%d D=%d" % (n, xq4.shape[0], D4), (n, xq4.shape[0]), gram4))
    for name, shape, make in gram_cases if all("mosm_gram.cu" in l for l in libs.values()) else ():
        cases.append((name, "mosm_gram.cu", 10, {
            side: (lambda o: (make(libs[side]["mosm_gram.cu"], o), o))(
                torch.zeros(shape, device=dev)) for side in libs}))
    if all("mosm_gram_bwd.cu" in l for l in libs.values()):
        cases.append(("K-gram-bwd %dx%d (parameter half)" % (n, n), "mosm_gram_bwd.cu", 10, {
            side: (lambda o: (gram_bwd(libs[side]["mosm_gram_bwd.cu"], o), o))(
                torch.zeros((O * O, nout), device=dev)) for side in libs}))
    if "family_matvec.cu" in built:
        cases += family_matvec_cases(libs, roots, gpr, cs, X, stream)
    if "family_gram_bwd.cu" in built:
        cases += family_gram_bwd_cases(libs, roots, gpr, cs, X, stream)
    if "family_lowrank_vjp.cu" in built:
        cases += family_lowrank_vjp_cases(libs, roots, gpr, cs, X, stream)
    if "family_gram.cu" in built:
        cases += family_gram_cases(libs, roots, gpr, cs, X, stream)
    if "mosm_matvec.cu" in built or "mosm_gram_lowrank_vjp.cu" in built:
        pts = phase21_points(cs, kernel, x, c)
        if "mosm_matvec.cu" in built:
            cases += gram_matvec_cases(libs, roots, pts, stats, O, Q, D, stream)
        if "mosm_gram_lowrank_vjp.cu" in built:
            cases += gram_lowrank_vjp_cases(libs, roots, pts, stats, O, Q, D, stream)
    for name, xx, cc, VV, reps in (("K-matvec N=%d R=33" % n, x, c, V, 10),
                                   ("K-matvec N=%d R=33" % nb, xb, cb, Vb, 5)):
        if all("mosm_matvec.cu" in l for l in libs.values()):
            cases.append((name, "mosm_matvec.cu", reps, {
                side: (lambda o: (matvec(libs[side]["mosm_matvec.cu"], o, xx, cc, VV), o))(
                    torch.empty_like(VV)) for side in libs}))

    for name, src, _, calls in cases:   # one checked call of each first, in order
        for side in ("old", "new"):
            err = calls[side][0]()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError("%s (%s) returned CUDA error %d" % (name, side, err))
        print("checked %s" % name, flush=True)
    times = {}
    for r in range(rounds):
        order = ["old", "new"] if r % 2 == 0 else ["new", "old"]
        for name, _, reps, calls in cases:
            for side in order:
                times.setdefault((name, side), []).append(cs.median_ms(calls[side][0], reps=reps))
    for name, src, _, calls in cases:
        for side in ("old", "new"):
            err = calls[side][0]()
            if err:
                raise RuntimeError("%s (%s) returned CUDA error %d" % (src, side, err))
        torch.cuda.synchronize()
        old, new = calls["old"][1], calls["new"][1]
        print("%s: old %s ms, new %s ms; max|old - new| %.3e (max|old| %.3e)"
              % (name, " ".join("%.3f" % t for t in times[(name, "old")]),
                 " ".join("%.3f" % t for t in times[(name, "new")]),
                 float((old - new).abs().max()), float(old.abs().max())))
    # each round's sum over the block columns of a per-column case
    groups = {}
    for name, _, _, _ in cases:
        if " j=" in name:
            groups.setdefault(name.split(" j=")[0], []).append(name)
    for group, names in groups.items():
        print("%s, sum over %d columns: old %s ms, new %s ms"
              % (group, len(names), *(" ".join("%.3f" % sum(times[(nm, side)][r] for nm in names)
                                                for r in range(rounds))
                                       for side in ("old", "new"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
