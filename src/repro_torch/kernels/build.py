"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``*.cu`` file under a kernel package's ``csrc/`` exports a plain C
interface and is compiled on its own into a shared library for Hopper
(``-gencode arch=compute_90a,code=sm_90a``).  Libraries go to
``build/repro_torch/`` at the root of the checkout, named by a hash of
their source and flags, so an edited source is rebuilt and an unchanged
one is reused.  Nothing is built when a module is imported: the first
launch of a kernel builds its library, and ``build_all`` builds every
missing library at once, one ``nvcc`` process per source, all started
together.

``CudaKernel`` binds one exported C function.  Its wrapper in the kernel
package checks the tensors and passes raw pointers; the kernel launches on
PyTorch's current stream, and a non-zero ``cudaError_t`` from the C
function raises.  ``launches`` counts successful launches, and nothing
else touches it, so a run can show which kernels its main path went
through.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


@dataclasses.dataclass
class BuildRecord:
    seconds: float  # nvcc wall time; 0.0 when the library was already built
    log: str        # nvcc's output (register and shared-memory use per kernel)


class CudaLibrary:
    """One CUDA source, the headers it includes and its compiler
    definitions, built into a shared library at first use."""

    def __init__(self, source: Path, headers: tuple[Path, ...] = (),
                 defines: tuple[str, ...] = ()):
        self.source = source
        self.headers = tuple(headers)
        self.defines = tuple(defines)  # "NAME=VALUE" compiler definitions
        self._handle: ctypes.CDLL | None = None

    @property
    def flags(self) -> list[str]:
        """nvcc's include directories and definitions for this library."""
        return ([f"-I{d}" for d in dict.fromkeys(str(h.parent) for h in self.headers)]
                + [f"-D{d}" for d in self.defines])

    @property
    def path(self) -> Path:
        text = b"".join(f.read_bytes() for f in (self.source, *self.headers))
        flags = " ".join((*NVCC_FLAGS, *self.defines))
        digest = hashlib.sha256(text + flags.encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def handle(self) -> ctypes.CDLL:
        if self._handle is None:
            build_all([self])
            self._handle = ctypes.CDLL(str(self.path))
        return self._handle


def build_all(libraries: list[CudaLibrary]) -> dict[str, BuildRecord]:
    """Build every library not built yet, with one nvcc per source in parallel.

    Each output is written under a temporary name and renamed into place,
    so an interrupted build never leaves a library that loads.  Raises
    with nvcc's output if any build fails.
    """
    records: dict[str, BuildRecord] = {}
    todo = []
    for lib in libraries:
        if lib.path.is_file():
            records[lib.source.name] = BuildRecord(0.0, "")
        else:
            todo.append(lib)
    if not todo:
        return records
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for lib in todo:
        tmp = lib.path.with_name(f"{lib.path.name}.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, *lib.flags, "-o", str(tmp), str(lib.source)]
        procs.append((lib, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for lib, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{lib.source}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib.path)
        records[lib.source.name] = BuildRecord(seconds, log)
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return records


class CudaKernel:
    """One exported C function of a ``CudaLibrary`` plus its launch count.

    ``argtypes`` are ctypes types; pointers and the stream go as
    ``ctypes.c_void_p`` (a plain int would be cut to 32 bits).  The C
    function returns a ``cudaError_t``.
    """

    def __init__(self, name: str, library: CudaLibrary, symbol: str, argtypes: list):
        self.name = name
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            handle = self.library.handle()
            fn = getattr(handle, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            handle.repro_cuda_error_string.argtypes = [ctypes.c_int]
            handle.repro_cuda_error_string.restype = ctypes.c_char_p
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = self.library.handle().repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1
