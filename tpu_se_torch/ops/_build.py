"""Build the port's native sources and load them with ``ctypes``.

Every ``csrc/*.cu`` file exposes a plain C interface (no PyTorch headers),
so ``nvcc`` compiles the whole set in seconds.  ``csrc/chunk_loader.cc`` is
host code (the pfile reader of ``tpu_se_torch/io/native.py``), built by the
host compiler into a library of its own (``build_host_library``).  Each
shared library lands in ``build/tpu_se_torch/`` beside the package, named
by a hash of its sources and its command, and is built at most once per
content: a changed source gets a new file, an unchanged one is reused.  A
build writes a temporary file and renames it into place, so processes that
build the same library at once (test workers, the ranks of a mesh) all end
with one whole file.  Nothing here runs at import.
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
# The host library's flags.  No -ffast-math, and no -march=native: the
# swap-and-normalise computes (x - mean) * inv_std, which holds no
# multiply-add to contract, so the instruction set changes no bit, and a
# library keyed by its sources and flags alone must run on any x86-64 host
# that a checkout's build directory travels to.
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
HOST_SOURCE = SRC_DIR / "chunk_loader.cc"


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


def find_cuobjdump() -> str:
    """``cuobjdump`` from the toolkit whose ``nvcc`` ``find_nvcc`` finds."""
    path = pathlib.Path(find_nvcc()).with_name("cuobjdump")
    if not (path.is_file() and os.access(path, os.X_OK)):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({path})")
    return str(path)


def count_sass_opcode(sass: str, opcode: str) -> dict[str, int]:
    """Per function of ``cuobjdump -sass`` output, how many instructions
    start with ``opcode`` (``DMMA`` counts ``DMMA.16x8x8`` and the like)."""
    counts = {}
    for chunk in sass.split("Function : ")[1:]:
        name, _, body = chunk.partition("\n")
        counts[name.strip()] = sum(
            1 for line in body.splitlines()
            if any(tok == opcode or tok.startswith(opcode + ".")
                   for tok in line.replace(";", " ").split()))
    return counts


def sass_opcode_counts(opcode: str) -> dict[str, int]:
    """``count_sass_opcode`` over the built library's SASS (builds it if
    needed)."""
    load_library()
    proc = subprocess.run(
        [find_cuobjdump(), "-sass", str(library_path(cuda_sources()))],
        capture_output=True, text=True, check=True)
    return count_sass_opcode(proc.stdout, opcode)


def cuda_sources() -> list[pathlib.Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def nvcc_command(nvcc: str, sources, output, defines=()) -> list[str]:
    """The full ``nvcc`` command line that builds ``sources`` into ``output``
    (``defines``: extra ``-DNAME=value`` flags, for a bench's variants)."""
    return [nvcc, *NVCC_FLAGS, *defines, "-o", str(output),
            *(str(s) for s in sources)]


def library_path(sources, defines=(), flags=NVCC_FLAGS,
                 stem: str = "libtpu_se_torch") -> pathlib.Path:
    """Where the library for these sources lives: keyed by content + flags
    (for the host library the compiler's name is among its flags)."""
    h = hashlib.sha256(" ".join((*flags, *defines)).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _compile(lib_path: pathlib.Path, command, what: str) -> str:
    """Run ``command(output)`` into a temporary file beside ``lib_path`` and
    rename it into place, unless ``lib_path`` exists -> the compiler's
    output ("" when an existing build was reused).  Raises with that output
    when the compiler fails or cannot be started."""
    if lib_path.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        argv = command(tmp)
        try:
            proc = subprocess.run(argv, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{what}: cannot run {argv[0]!r} ({e})") from e
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{what} failed ({proc.returncode}):\n"
                               f"{' '.join(argv)}\n{log}")
        os.replace(tmp, lib_path)    # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return log


def build_library(sources, defines=()) -> tuple[pathlib.Path, str]:
    """Build ``sources`` (if not built yet) -> (library path, compiler log).

    The compiler log holds ``-Xptxas -v``'s registers/spills per kernel; it
    is empty when an existing build was reused.  Raises on a missing nvcc or
    a failed compile, with nvcc's output in the message.
    """
    lib_path = library_path(sources, defines)
    return lib_path, _compile(
        lib_path, lambda out: nvcc_command(find_nvcc(), sources, out, defines),
        "nvcc")


def host_compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++``."""
    return os.environ.get("CXX") or "c++"


def host_command(cxx: str, sources, output) -> list[str]:
    """The full host-compiler command that builds ``sources`` into the
    shared library ``output``."""
    return [cxx, *HOST_FLAGS, "-o", str(output), *(str(s) for s in sources)]


def build_host_library(sources=(HOST_SOURCE,)) -> tuple[pathlib.Path, str]:
    """Build the host library (``csrc/chunk_loader.cc``) with
    ``host_compiler()`` if not built yet -> (library path, compiler log).
    Raises with the compiler's output when the build fails."""
    cxx = host_compiler()
    lib_path = library_path(sources, flags=(cxx, *HOST_FLAGS),
                            stem="libtpu_se_torch_host")
    return lib_path, _compile(
        lib_path, lambda out: host_command(cxx, sources, out), cxx)


def bind_ggd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of ``csrc/ggd_kernel.cu``'s C interface."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.ggd_output_grad, lib.ggd_output_grad_general):
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, f32, f32, f32, ptr]
        fn.restype = i32
    lib.ggd_colsum.argtypes = [ptr, ptr, ptr, i32, i32, f32, ptr]
    lib.ggd_colsum.restype = i32
    lib.ggd_grad_from_sums.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                       f32, f32, f32, ptr]
    lib.ggd_grad_from_sums.restype = i32
    lib.ggd_plan.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.ggd_plan.restype = None
    lib.ggd_launch_floor.argtypes = [i32, i32, ptr]
    lib.ggd_launch_floor.restype = i32
    return lib


@functools.cache
def load_library() -> tuple[ctypes.CDLL, str]:
    """Build (if needed) and load the kernels -> (library, compiler log),
    as ``build_library`` over every ``csrc/*.cu``."""
    lib_path, log = build_library(cuda_sources())
    lib = bind_ggd(ctypes.CDLL(str(lib_path)))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lps_forward.argtypes = [ptr, ptr, ptr, i32, i32, i32, f32, f32, ptr]
    lib.lps_forward.restype = i32
    lib.lps_grid_blocks.argtypes = [i32, i32]
    lib.lps_grid_blocks.restype = ctypes.c_longlong
    # csrc/sgd_kernel.cu: the entries are a ctypes array of
    # ops/sgd_kernel.py:_Entry, passed as a pointer.
    lib.sgd_momentum_update.argtypes = [ptr, i32, ptr, f32, f32, f32, ptr]
    lib.sgd_momentum_update.restype = i32
    lib.sgd_launch_floor.argtypes = [ctypes.c_longlong, ptr]
    lib.sgd_launch_floor.restype = i32
    lib.sgd_grid_blocks.argtypes = [ctypes.c_longlong]
    lib.sgd_grid_blocks.restype = i32
    return lib, log
