"""ctypes bindings for the native runtime pieces (the port of
``paddle_tpu/native/__init__.py``).

Three libraries, each built with ``g++`` at first use into
``paddle_tpu_torch/build/native/`` (listed in ``.gitignore``) and named
by a digest of its sources and flags, so a stale build is never loaded:

- ``libptn``: ``native/src/recordio.cpp`` and ``shuffle_pool.cpp`` — the
  recordio writer, index and chunk reader, and the background shuffle
  pool (a producer thread keeping a shuffle window full);
- ``libptpu_aot``: ``native/src/aot_runtime.cpp`` — the interpreter-free
  inference runtime of ``.ptnm`` programs (:func:`~paddle_tpu_torch.
  export.export_aot_program` writes them);
- ``libptpu_capi``: ``paddle_tpu_torch/native/capi.cpp`` — the C
  inference ABI over merged models, hosting an embedded CPython that
  loads :mod:`paddle_tpu_torch.export`.

The first two are built from the repository's ``native/src`` sources as
they are (they link no Python and no framework), so the ``.ptnm`` writer
and the runtime read one format.  A failed build raises with the
compiler's output; nothing falls back to the pure-Python recordio.  The
PJRT C-API runtime of the JAX package (``build_pjrt``) has no
counterpart: it dlopens a TPU plugin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

from paddle_tpu_torch.platform.enforce import EnforceError

PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PKG_DIR.parent / "native" / "src"
BUILD_DIR = PKG_DIR / "build" / "native"
CAPI_SRC = Path(__file__).resolve().parent / "capi.cpp"

_CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_build_lock = threading.Lock()
_lib = None


def _compile(name: str, sources: Sequence[Path], extra: Sequence[str] = (),
             deps: Sequence[Path] = (), force: bool = False) -> str:
    """``g++`` ``sources`` into ``BUILD_DIR/lib<name>-<digest>.so``
    unless that file exists; returns its path.  The compiler's output
    rides the raised error."""
    for s in sources:
        if not s.exists():
            raise EnforceError(f"no native source {s}", context="native")
    cxx = shutil.which("g++")
    if cxx is None:
        raise EnforceError("g++ not found on PATH: the native libraries "
                           "are built from source", context="native")
    h = hashlib.sha256(" ".join((*_CXX_FLAGS, *extra)).encode())
    for s in (*sources, *deps):
        h.update(s.name.encode() + s.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    with _build_lock:
        if out.exists() and not force:
            return str(out)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *_CXX_FLAGS, "-o", str(tmp), *map(str, sources),
               *extra]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise EnforceError(
                f"building lib{name} failed (exit {proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stderr}", context="native")
        # other processes may build the same digest: the rename is atomic
        os.replace(tmp, out)
    return str(out)


def build(force: bool = False) -> str:
    """``native/src/recordio.cpp`` + ``shuffle_pool.cpp`` ->
    ``libptn`` (no Python linkage)."""
    return _compile("ptn", [SRC_DIR / "recordio.cpp",
                            SRC_DIR / "shuffle_pool.cpp"],
                    extra=("-lpthread",),
                    deps=sorted(SRC_DIR.glob("*.h")), force=force)


def build_aot(force: bool = False) -> str:
    """``native/src/aot_runtime.cpp`` -> ``libptpu_aot``: plain C++, no
    Python, no torch linked — the embedded-deployment artifact."""
    return _compile("ptpu_aot", [SRC_DIR / "aot_runtime.cpp"], force=force)


def build_capi(force: bool = False) -> str:
    """``paddle_tpu_torch/native/capi.cpp`` -> ``libptpu_capi``, linked
    against this interpreter's shared libpython."""
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION")
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise EnforceError(
            f"this Python ({sysconfig.get_config_var('LDLIBRARY')}) has no "
            "shared libpython: the C inference ABI embeds the interpreter",
            context="native")
    return _compile("ptpu_capi", [CAPI_SRC],
                    extra=(f"-I{inc}", f"-L{libdir}", f"-lpython{ver}",
                           f"-Wl,-rpath,{libdir}", "-lpthread"),
                    force=force)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    u64, p = ctypes.c_uint64, ctypes.c_void_p
    sigs: Dict[str, tuple] = {
        "ptn_write_open": (p, [ctypes.c_char_p]),
        "ptn_write_record": (ctypes.c_int, [p, ctypes.c_char_p, u64]),
        "ptn_write_close": (u64, [p]),
        "ptn_index": (ctypes.c_int, [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(u64)),
            ctypes.POINTER(u64)]),
        "ptn_free_offsets": (None, [ctypes.POINTER(u64)]),
        "ptn_read_chunk": (p, [ctypes.c_char_p, u64, u64]),
        "ptn_buf_count": (u64, [p]),
        "ptn_buf_get": (ctypes.c_int, [p, u64,
                                       ctypes.POINTER(ctypes.c_char_p),
                                       ctypes.POINTER(u64)]),
        "ptn_buf_free": (None, [p]),
        "ptn_pool_create": (p, [ctypes.POINTER(ctypes.c_char_p), u64, u64,
                                u64]),
        "ptn_pool_next": (ctypes.c_int, [p, ctypes.POINTER(ctypes.c_char_p),
                                         ctypes.POINTER(u64)]),
        "ptn_pool_destroy": (None, [p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _lib = lib
    return _lib


def available() -> bool:
    """True once ``libptn`` is built and loaded; False only without a
    ``g++`` on PATH.  A build that fails raises."""
    if shutil.which("g++") is None:
        return False
    return _load() is not None


# ---------------------------------------------------------------------------
# recordio
# ---------------------------------------------------------------------------


def write_records(path: str, records: Iterable[bytes]) -> int:
    lib = _load()
    h = lib.ptn_write_open(path.encode())
    if not h:
        raise OSError(f"cannot open {path}")
    n = 0
    for rec in records:
        if isinstance(rec, str):
            rec = rec.encode()
        if lib.ptn_write_record(h, rec, len(rec)) != 0:
            lib.ptn_write_close(h)
            raise OSError(f"short write to {path}")
        n += 1
    if lib.ptn_write_close(h) == 2 ** 64 - 1:  # the flush failed
        raise OSError(f"flush failed writing {path}")
    return n


def index(path: str) -> List[int]:
    lib = _load()
    arr = ctypes.POINTER(ctypes.c_uint64)()
    n = ctypes.c_uint64()
    if lib.ptn_index(path.encode(), ctypes.byref(arr),
                     ctypes.byref(n)) != 0:
        raise OSError(f"cannot index {path}")
    out = [arr[i] for i in range(n.value)]
    lib.ptn_free_offsets(arr)
    return out


def read_chunk(path: str, offset: int, count: int) -> List[bytes]:
    lib = _load()
    h = lib.ptn_read_chunk(path.encode(), offset, count)
    if not h:
        raise OSError(f"cannot read {path}")
    out = []
    data = ctypes.c_char_p()
    length = ctypes.c_uint64()
    for i in range(lib.ptn_buf_count(h)):
        lib.ptn_buf_get(h, i, ctypes.byref(data), ctypes.byref(length))
        out.append(ctypes.string_at(data, length.value))
    lib.ptn_buf_free(h)
    return out


# ---------------------------------------------------------------------------
# the async shuffle pool (the native data loader)
# ---------------------------------------------------------------------------


class ShufflePool:
    """Background-thread record streamer with a shuffle window: iterating
    yields raw record bytes in shuffled order while the native producer
    thread keeps the window full (reading overlaps compute)."""

    def __init__(self, paths: List[str], window: int = 1024, seed: int = 0):
        self._lib = _load()
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._h = self._lib.ptn_pool_create(arr, len(paths), window, seed)

    def __iter__(self):
        data = ctypes.c_char_p()
        length = ctypes.c_uint64()
        while True:
            rc = self._lib.ptn_pool_next(self._h, ctypes.byref(data),
                                         ctypes.byref(length))
            if rc < 0:
                raise OSError("shuffle pool IO error (missing file or "
                              "corrupt record stream)")
            if rc == 0:
                return
            yield ctypes.string_at(data, length.value)

    def close(self):
        if self._h:
            self._lib.ptn_pool_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def recordio_reader(paths, window: int = 1024, seed: int = 0):
    """Reader creator over native recordio files with async shuffling
    (the v2 reader protocol: call -> iterator of records)."""
    if isinstance(paths, str):
        paths = [paths]

    def reader():
        pool = ShufflePool(list(paths), window=window, seed=seed)
        try:
            yield from pool
        finally:
            pool.close()

    return reader
