"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded
with :mod:`ctypes`.  Pointers are ``tensor.data_ptr()`` and the stream
is PyTorch's current stream, both passed as ``c_void_p``; every launch
function returns the ``cudaError_t`` of its launch, and :func:`check`
raises on anything but success.  No PyTorch header is compiled, so a
build takes seconds (a source that includes ``torch/extension.h``
takes minutes).

Nothing is built at import.  The first call of :func:`library` starts
one ``nvcc`` per source, all together, into ``build/torch_ext/`` of the
checkout (``.gitignore`` lists ``build/``).  A library is named after a
hash of its source and flags, so a changed source is rebuilt and an
unchanged one is reused.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
SOURCES = ("linearity.cu", "blockmed.cu", "contract.cu", "ipc_fwd.cu", "pink.cu",
           "ipc_slab.cu", "invlin.cu")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_LIBS = {}
_LOCK = threading.Lock()


def nvcc():
    """Path of the CUDA compiler (``$CUDA_HOME/bin``, ``PATH``, or
    ``/usr/local/cuda/bin``)."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(src):
    h = hashlib.sha1((CSRC / src).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(src).stem}_{h.hexdigest()[:12]}.so"


def build_all():
    """Compile every source not built yet, one ``nvcc`` each, in
    parallel.  Returns ``{source: library path}``; raises with the
    compiler's output if any build fails.  ``nvcc``'s report (``-Xptxas
    -v``: registers, shared memory, spills per kernel) is kept beside
    each library as ``<name>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {src: _target(src) for src in SOURCES}
    procs = {}
    for src, lib in targets.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        procs[src] = (tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for src, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        targets[src].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, targets[src])  # atomic: no torn library
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def _declare(lib):
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (
        ("linearity_cube_launch", (P, P, P, P, P, P, P, P, P, I, I, L, I, P)),
        ("block_nanmedian_launch", (P, P, I, I, L, I, I, I, P)),
        ("contract_reads_launch", (P, P, P, I, I, L, I, P)),
        ("ipc_fwd_cube_launch", (P, P, P, P, I, I, P)),
        ("pink_frames_launch", (P,) * 11 + (I, I, I, P)),
        ("pink_frames_wgmma_launch", (P,) * 10 + (I, I, I, P)),
        ("ipc_slab_launch",
         (P, L, I, P, L, I, P, L, I, P, I, I, I, I, I, I, P, L, P, L, I, I, I, I, I,
          I, I, I, I, P)),
        ("ipc_slab_resident", (I, I, P)),
        ("invert_linearity_launch", (P,) * 7 + (I, I, I, I, L, I, I, P)),
    ):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = I
    return lib


def library(src):
    """The loaded ctypes library of ``csrc/<src>`` (built at first use)."""
    with _LOCK:
        if not _LIBS:
            for s, path in build_all().items():
                _LIBS[s] = _declare(ctypes.CDLL(str(path)))
        return _LIBS[src]


def check(err, what):
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(tensor):
    """PyTorch's current stream on the tensor's device, as a pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)


def require(tensor, name, dtype, shape):
    """Wrapper-side checks before a pointer reaches a kernel: a CUDA
    tensor of the given dtype and shape, C-contiguous."""
    if tensor.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {tensor.device}")
    if tensor.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {tensor.dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(tensor.shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
