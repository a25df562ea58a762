"""Build and load the hand-written CUDA kernels in mogptk_tpu_torch/csrc/.

No JAX counterpart: the JAX package's Pallas kernels are compiled by XLA.
Here `nvcc` compiles every csrc/*.cu into an object, one process per source,
all started together, and links them into one shared library with a plain C
interface, at first use, into mogptk_tpu_torch/_build/<hash of the sources
and flags>/ (the compiler's register and spill report goes to build.log
beside it); ctypes loads it. Each C entry point launches on the stream it is
given and returns its cudaError_t; `check` turns a nonzero code into an
exception. Nothing is built when this module is imported.
"""
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
LIB_NAME = "libmogptk_kernels.so"

# sm_90a, not sm_90: the Hopper-only instructions (wgmma, setmaxnreg) exist
# only for the "a" target. No --use_fast_math: the Gram's cosine arguments
# reach ~250 rad, where the fast __cosf is badly wrong.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_ptr = ctypes.c_void_p
_c_i64 = ctypes.c_int64
_c_int = ctypes.c_int

# C signatures of csrc/*.cu, every pointer and the stream as void*
SIGNATURES = {
    # x1, c1, x2, c2, stats, out, N, M, O, Q, D, stream
    "mosm_gram_f32": [_c_ptr] * 6 + [_c_i64, _c_i64, _c_int, _c_int, _c_int, _c_ptr],
    # L, S, n, r0, B, stream
    "s_panel_f32": [_c_ptr, _c_ptr, _c_i64, _c_i64, _c_i64, _c_ptr],
    # L, S, Ljj, inv, n, r0, B, zero_upper, stream
    "col_write_f32": [_c_ptr] * 4 + [_c_i64, _c_i64, _c_i64, _c_int, _c_ptr],
    # x, c, stats, out, N, O, Q, D, tile, band, stream
    "mosm_gram_lower_f32": [_c_ptr] * 4 + [_c_i64, _c_int, _c_int, _c_int, _c_i64, _c_i64, _c_ptr],
    # idx, x, A, B, stats, partial, pairs, out, S, P, Q, D, R, stream
    "mosm_lowrank_vjp_f32": [_c_ptr] * 8 + [_c_int] * 5 + [_c_ptr],
    # idx, g, x1, rmap, x2, cmap, stats, partial, pairs, out, S, P, M, Q, D, stream
    "mosm_gram_bwd_f32": [_c_ptr] * 10 + [_c_int, _c_int, _c_i64, _c_int, _c_int, _c_ptr],
    # L, invs, V, Z, X, n, B, R, stream
    "fused_cho_solve_f32": [_c_ptr] * 5 + [_c_i64, _c_i64, _c_int, _c_ptr],
}


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def nvcc_path():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def nvcc_commands(output, nvcc="nvcc"):
    """The nvcc command lines that build the kernel library at `output`: one
    compile per source (run in parallel), then the link."""
    objs = [output + "." + os.path.basename(src) + ".o" for src in sources()]
    compiles = [[nvcc] + NVCC_FLAGS + ["-I", CSRC_DIR, "-c", src, "-o", obj]
                for src, obj in zip(sources(), objs)]
    return compiles, [nvcc, "-shared", "-o", output] + objs


def source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build():
    """Compile the library if this source hash has not been built yet;
    returns its path. Compiles to a temporary name, then renames, so a
    concurrent build never loads a half-written file."""
    out_dir = os.path.join(BUILD_DIR, source_hash())
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    compiles, link = nvcc_commands(tmp, nvcc_path())
    log = []
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        outs = [p.communicate()[0] for p in procs]
        for cmd, p, out in zip(compiles, procs, outs):
            log.append(" ".join(cmd) + "\n" + out)
            if p.returncode != 0:
                raise RuntimeError("nvcc failed (exit %d):\n%s" % (p.returncode, log[-1]))
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed (exit %d):\n%s\n%s"
                               % (proc.returncode, proc.stdout, proc.stderr))
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write("\n".join(log))
        os.replace(tmp, lib)
    finally:
        for path in [tmp] + link[3:]:
            if os.path.exists(path):
                os.remove(path)
    return lib


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mogptk_error_string.argtypes = [ctypes.c_int]
    lib.mogptk_error_string.restype = ctypes.c_char_p
    return lib


def check(err, name):
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        msg = library().mogptk_error_string(err).decode()
        raise RuntimeError("CUDA kernel %s failed: cudaError_t %d (%s)" % (name, err, msg))


def stream_ptr(tensor):
    """PyTorch's current CUDA stream on the tensor's device, as void*."""
    return torch.cuda.current_stream(tensor.device).cuda_stream


def require_cuda_inputs(name, floats=(), ints=()):
    """The checks every kernel wrapper makes before a launch: float32 (int32)
    tensors, contiguous, on one CUDA device, without autograd history (a
    kernel's backward, where it has one, is another kernel called from a
    torch.autograd.Function). Raises instead of falling back."""
    tensors = list(floats) + list(ints)
    device = tensors[0].device
    for t in tensors:
        if t.device != device or t.device.type != "cuda":
            raise ValueError("%s: every input must be on %s, got %s" % (name, device, t.device))
        if not t.is_contiguous():
            raise ValueError("%s: inputs must be contiguous" % name)
        if t.requires_grad:
            raise ValueError("%s: the CUDA kernel has no backward; call it under torch.no_grad()" % name)
    for t in floats:
        if t.dtype != torch.float32:
            raise TypeError("%s: the CUDA kernel takes float32, got %s" % (name, t.dtype))
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError("%s: channel IDs must be int32, got %s" % (name, t.dtype))
