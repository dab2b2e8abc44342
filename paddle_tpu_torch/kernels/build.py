"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``paddle_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``paddle_tpu_torch/build/`` (listed in ``.gitignore``), named by a hash of
the source and flags so a stale build is never loaded.  The library is
opened with ``ctypes``: pointers go in as ``c_void_p``, the stream as
``torch.cuda.current_stream().cuda_stream``, and each C entry returns a
``cudaError_t`` the Python wrapper raises on.  Nothing here runs at import
time; the sources come from the repository only.

A plain C interface keeps a build to seconds: a source that includes
PyTorch's headers (``torch.utils.cpp_extension``) takes minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from paddle_tpu_torch.platform.enforce import EnforceError

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library; filled on first use, never mutated after
_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, ptxas report) of the build this process ran, if any
BUILD_LOG: Dict[str, Tuple[float, str]] = {}

Signatures = Dict[str, Tuple[Sequence[object], object]]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise EnforceError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built from source on the card's "
                       "machine", context="kernels")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise EnforceError(f"no CUDA source {src}", context="kernels")
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path, Path,
                                        float]]:
    src, out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, job) -> None:
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise EnforceError(f"nvcc failed building {name} "
                           f"(exit {proc.returncode}):\n{log}",
                           context="kernels")
    out.with_suffix(".log").write_text(log)   # the ptxas report, kept
    os.replace(tmp, out)   # atomic: a half-written library is never loaded
    BUILD_LOG[name] = (time.perf_counter() - t0, log)


def build(names: Iterable[str]) -> None:
    """Compile every named source that has no current build, one ``nvcc``
    per source, all started together."""
    jobs: List[Tuple[str, object]] = []
    errors: List[EnforceError] = []
    try:
        for name in names:
            job = _start(name)
            if job is not None:
                jobs.append((name, job))
    finally:
        # wait for every started nvcc, even after a failure
        for name, job in jobs:
            try:
                _finish(name, job)
            except EnforceError as err:
                errors.append(err)
    if errors:
        raise errors[0]


def load(name: str, signatures: Signatures) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed,
    with ``argtypes``/``restype`` set from ``signatures``
    (``{symbol: (argtypes, restype)}``)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)[1]))
        for sym, (argtypes, restype) in signatures.items():
            fn = getattr(lib, sym)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        _LIBS[name] = lib
    return lib


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of each kernel of ``csrc/<name>.cu``
    from the ``-Xptxas -v`` report of its current build (empty when it
    has none): ``{mangled kernel name: {"registers", "spill_stores",
    "spill_loads"}}``."""
    if name in BUILD_LOG:
        log = BUILD_LOG[name][1]
    else:
        saved = _target(name)[1].with_suffix(".log")
        log = saved.read_text() if saved.exists() else ""
    report: Dict[str, Dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = report.setdefault(entry.group(1), {})
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if current is not None and spill:
            current["spill_stores"] = int(spill.group(1))
            current["spill_loads"] = int(spill.group(2))
        if current is not None and regs:
            current["registers"] = int(regs.group(1))
    return report


def sources() -> List[str]:
    """Every kernel source in the package, by name."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
