"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled for Hopper (``sm_90a``) at first use into
``build/repro_torch/`` at the root of the checkout. The file name carries a
content hash of the sources (the ``.cu``, every ``.cuh`` beside it, and the
flags), so a stale library is never loaded. ``build()`` starts one ``nvcc``
per missing library, all at once, and waits for every one of them.

Two kinds of failure, kept apart for the degradation ladder of
``kernels.ops.numeric_values`` and ``core.executor.ReuseExecutor``:

* a library that cannot be built or loaded raises ``KernelBuildError``, a
  typed ``KernelFallbackError``. The ladder lets it through and never steps
  past it, so a broken build can never pass for a working path (the
  reference's ladder also absorbs lowering failures: a documented
  difference), and the serving tier never retries it;
* a launch that returns a CUDA error raises ``KernelLaunchError``, an
  untyped ``RuntimeError`` outside the taxonomy (like
  ``runtime.faults.InjectedFault``). The ladder treats it as a kernel
  failure: it steps to the next rung on the same device, or, under
  ``on_kernel_failure="raise"`` or when the rungs run out, raises
  ``KernelFallbackError`` from it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.runtime.validate import KernelFallbackError


class KernelBuildError(KernelFallbackError):
    """A kernel library could not be built or loaded: deterministic, so it is
    neither a rung of the ladder nor worth a retry."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error. Deliberately outside the typed
    ``SpgemmError`` taxonomy: the degradation ladder handles it as a kernel
    failure."""


CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("segsum_reuse", "lp_reuse", "spgemm_symbolic", "spgemm_numeric", "spgemm_lp",
           "bsr_spgemm", "grouped_matmul", "flash_attention", "plan_columns")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# nvcc's report per library built by this process (ptxas registers, spills)
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_SMS: dict = {}  # device -> its SM count


def nvcc_path() -> str:
    """The ``nvcc`` on PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc): "
        "the CUDA kernels of repro_torch are built from source at first use")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Build every missing library of ``names`` in parallel; return paths."""
    paths = {name: library_path(name) for name in names}
    missing = [name for name, path in paths.items() if not path.exists()]
    if not missing:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        tmp = paths[name].with_name(f"{paths[name].name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])  # atomic: readers never see half a file
    if failed:
        raise KernelBuildError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build((name,))[name]
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        _LIBS[name] = lib
    return lib


def launch(name: str, argtypes, *args, entry: str = "launch") -> None:
    """Call ``<name>_<entry>(*args)`` of ``csrc/<name>.cu``, whose C arguments
    are ``argtypes`` and which returns ``cudaGetLastError()``; a CUDA error
    raises ``KernelLaunchError``, which the degradation ladder catches."""
    lib = load(name)
    fn = getattr(lib, f"{name}_{entry}")
    err_str = getattr(lib, f"{name}_error_string")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
    err = fn(*args)
    if err != 0:
        raise KernelLaunchError(
            f"{name} kernel launch failed: CUDA error {err} ({err_str(err).decode()})")


def sm_count(device) -> int:
    """The SMs of a CUDA device (cached: they size the kernels' device
    slices)."""
    found = _SMS.get(device)
    if found is None:
        found = _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return found
