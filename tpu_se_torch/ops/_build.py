"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file exposes a plain C interface (no PyTorch headers),
so ``nvcc`` compiles the whole set in seconds.  The shared library lands in
``build/tpu_se_torch/`` beside the package, named by a hash of the sources
and the command, and is built at most once per content: a changed source
gets a new file, an unchanged one is reused.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "tpu_se_torch"

# sm_90a, not sm_90: later kernels use wgmma/setmaxnreg, which exist only
# for the arch-specific target.  No --use_fast_math: the LPS epilogue needs
# the IEEE logf and an exact compare against the e^-50 floor, and the GGD
# gradient the IEEE powf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file() and os.access(cand, os.X_OK):
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA toolkit is "
                       "needed to build tpu_se_torch's kernels")


def cuda_sources() -> list[pathlib.Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def nvcc_command(nvcc: str, sources, output) -> list[str]:
    """The full ``nvcc`` command line that builds ``sources`` into ``output``."""
    return [nvcc, *NVCC_FLAGS, "-o", str(output), *(str(s) for s in sources)]


def library_path(sources) -> pathlib.Path:
    """Where the library for these sources lives: keyed by content + flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpu_se_torch_{h.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> tuple[ctypes.CDLL, str]:
    """Build (if needed) and load the kernels -> (library, compiler log).

    The compiler log holds ``-Xptxas -v``'s registers/spills per kernel; it
    is empty when an existing build was reused.  Raises on a missing nvcc or
    a failed compile, with nvcc's output in the message.
    """
    sources = cuda_sources()
    lib_path = library_path(sources)
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(nvcc_command(find_nvcc(), sources, tmp),
                                  capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, lib_path)    # atomic: concurrent builds agree
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lps_forward.argtypes = [ptr, ptr, ptr, i32, i32, i32, f32, f32, ptr]
    lib.lps_forward.restype = i32
    lib.ggd_output_grad.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, f32,
                                    f32, f32, ptr]
    lib.ggd_output_grad.restype = i32
    return lib, log
