#!/usr/bin/env python3
"""A/B of the MOSM Gram kernels of two source trees on one NVIDIA GPU.

    python3 kernel_ab.py OLD_ROOT [NEW_ROOT] [--rounds N]

Each ROOT is a checkout of this repository (for example a `git archive` of
another commit unpacked into a directory that .gitignore lists); NEW_ROOT
defaults to the directory of this script. From each root it builds
mogptk_tpu_torch/csrc/mosm_gram.cu (K-gram) and, where the root has them,
mosm_matvec.cu (K-matvec) and mosm_gram_bwd.cu (K-gram-bwd) with that
root's own headers and the nvcc flags of ops/_build.py, each into a library
of its own under NEW_ROOT/mogptk_tpu_torch/_build/ab/, and calls them in the
same process on the same inputs: the 4 x 4,096-point bench model of
chip_smoke.py (K-gram over 16,384^2, 16,384 x 4,096 and the band-lower Gram;
K-matvec at R = 33; K-gram-bwd's parameter half on a dense 16,384^2
cotangent, its unrolled instance, the closed-form step's call) and K-matvec
at benchmarks/bignum_exact.py's N = 65,536, R = 33. A root whose kernels
take an instance argument (`int generic`) gets 0, the unrolled instance;
K-gram-bwd's input half is off (inputs = 0). Rounds
alternate which side runs first; each prints its CUDA-event medians (10
calls, 5 at N = 65,536) per case and side, then the largest difference
between the two sides' outputs. Prints the card's name and power limit
first. Exits nonzero without CUDA or when a build fails.
"""
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("mosm_gram.cu", "mosm_matvec.cu", "mosm_gram_bwd.cu")
# sources a library also needs where the root has them (K-gram-bwd's
# instances with the input half are compiled from a file of their own)
COMPANIONS = {"mosm_gram_bwd.cu": ("mosm_gram_bwd_inputs.cu",)}


def takes_instance(root):
    """True when root's kernels take the instance argument `generic`."""
    with open(os.path.join(root, "mogptk_tpu_torch", "csrc", "mosm_gram.cu")) as f:
        return "int generic" in f.read()


def build(root, out_dir, tag, nvcc, flags):
    """{source: ctypes library} for the sources present in root's csrc, each
    compiled by its own nvcc process, all started together."""
    csrc = os.path.join(root, "mogptk_tpu_torch", "csrc")
    procs = {}
    for src in SOURCES:
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
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"old": os.path.abspath(args[0]),
             "new": os.path.abspath(args[1]) if len(args) > 1 else HERE}
    sys.path.insert(0, roots["new"])
    import chip_smoke as cs
    import mogptk_tpu_torch.gpr as gpr
    from mogptk_tpu_torch.ops import _build, block_mosm as bm, mosm_gram as mg

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    out_dir = os.path.join(roots["new"], "mogptk_tpu_torch", "_build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    libs = {side: build(root, out_dir, side, _build.nvcc_path(), list(_build.NVCC_FLAGS))
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

    def gram(lib, out, x2, c2):
        tail = inst[side_of[id(lib)]] + [P(stream)]
        return lambda: lib.mosm_gram_f32(ptr(x), ptr(c), ptr(x2), ptr(c2), ptr(stats), ptr(out),
                                         I64(n), I64(x2.shape[0]), I32(O), I32(Q), I32(D), *tail)

    def lower(lib, out):
        tail = inst[side_of[id(lib)]] + [P(stream)]
        return lambda: lib.mosm_gram_lower_f32(ptr(x), ptr(c), ptr(stats), ptr(out), I64(n),
                                               I32(O), I32(Q), I32(D), I64(bm.TILE), I64(512),
                                               *tail)

    def matvec(lib, out, xx, cc, VV):
        tail = inst[side_of[id(lib)]] + [P(stream)]
        return lambda: lib.mosm_matvec_f32(ptr(xx), ptr(cc), ptr(stats), ptr(VV), ptr(out),
                                           I64(xx.shape[0]), I32(VV.shape[1]), I32(O), I32(Q),
                                           I32(D), *tail)

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
    for name, shape, make in (
            ("K-gram %dx%d" % (n, n), (n, n), lambda lib, o: gram(lib, o, x, c)),
            ("K-gram %dx%d" % (n, xq.shape[0]), (n, xq.shape[0]),
             lambda lib, o: gram(lib, o, xq, cq)),
            ("K-gram-lower %dx%d band 512" % (n, n), (n, n), lower)):
        cases.append((name, "mosm_gram.cu", 10, {
            side: (lambda o: (make(libs[side]["mosm_gram.cu"], o), o))(
                torch.zeros(shape, device=dev)) for side in libs}))
    if all("mosm_gram_bwd.cu" in l for l in libs.values()):
        cases.append(("K-gram-bwd %dx%d (parameter half)" % (n, n), "mosm_gram_bwd.cu", 10, {
            side: (lambda o: (gram_bwd(libs[side]["mosm_gram_bwd.cu"], o), o))(
                torch.zeros((O * O, nout), device=dev)) for side in libs}))
    for name, xx, cc, VV, reps in (("K-matvec N=%d R=33" % n, x, c, V, 10),
                                   ("K-matvec N=%d R=33" % nb, xb, cb, Vb, 5)):
        if all("mosm_matvec.cu" in l for l in libs.values()):
            cases.append((name, "mosm_matvec.cu", reps, {
                side: (lambda o: (matvec(libs[side]["mosm_matvec.cu"], o, xx, cc, VV), o))(
                    torch.empty_like(VV)) for side in libs}))

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
        print("%s: old %s ms, new %s ms; max|old - new| %.3e"
              % (name, " ".join("%.3f" % t for t in times[(name, "old")]),
                 " ".join("%.3f" % t for t in times[(name, "new")]),
                 float((old - new).abs().max())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
