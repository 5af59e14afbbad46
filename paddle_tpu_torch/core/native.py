"""ctypes bridge to the repo's C++ host runtime (counterpart of
paddle_tpu/core/native.py).

The library under ``native/`` is host-side runtime only: the stat registry
(ref platform/monitor.h:43), the host event profiler (platform/profiler.h:126)
and the multi-slot DataFeed engine (framework/data_feed.h:108: parallel
parse, shuffle and batch assembly off the GIL).  No device memory or kernel
goes through it.  The port binds the same ``pt_*`` C ABI the JAX package
binds.

The JAX package runs ``make -C native`` into ``native/build/``.  The port
compiles ``native/src/*.cc`` itself with ``g++ -O2 -std=c++17 -fPIC
-pthread -Inative/include``, one compiler per source, all started together,
into ``build/paddle_tpu_torch/native/`` at the root of the checkout (listed
in ``.gitignore``), under a name keyed on a hash of the sources, the
headers and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  Nothing is written under ``native/``.

The library is built at first use, never at import.  When the toolchain or
the build fails, ``available()`` is False, ``build_error()`` says why, and
callers take their pure-Python routes (``io.multislot._PySlotFeed``, the
dict-backed stats), as in the JAX package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _REPO_ROOT / "native"
BUILD_DIR = _REPO_ROOT / "build" / "paddle_tpu_torch" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False
_build_error: Optional[str] = None
_build_seconds: Optional[float] = None


def _sources():
    return sorted((NATIVE_DIR / "src").glob("*.cc"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for p in _sources() + sorted((NATIVE_DIR / "include").rglob("*.h")):
        h.update(p.relative_to(NATIVE_DIR).as_posix().encode())
        h.update(p.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpaddle_tpu_native-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Build the library if it is missing; returns the build's seconds
    (0.0 when it was already built).  A failed build raises with the
    compiler's output."""
    out = library_path()
    if out.exists():
        return 0.0
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native host runtime is built "
                           "with a C++17 compiler")
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"tmp-{os.getpid()}-{threading.get_ident()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        include = f"-I{NATIVE_DIR / 'include'}"
        procs = []
        for src in _sources():
            obj = tmp / f"{src.stem}.o"
            procs.append((src, obj, subprocess.Popen(
                [cxx, *CXX_FLAGS, include, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, _, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("native runtime build failed:\n"
                               + "\n".join(failed))
        so = tmp / out.name
        link = subprocess.run(
            [cxx, "-shared", *(str(o) for _, o, _ in procs), "-o", str(so),
             "-pthread", "-ldl"], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"native runtime link failed:\n{link.stderr}")
        # atomic: a concurrent build of the same sources writes the same
        # bytes under the same name
        os.replace(so, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return time.perf_counter() - t0


def _try_build() -> bool:
    global _build_attempted, _build_error, _build_seconds
    if _build_attempted:
        return _build_error is None
    _build_attempted = True
    if not (NATIVE_DIR / "src").is_dir():
        _build_error = f"no native sources under {NATIVE_DIR}"
        return False
    try:
        _build_seconds = build()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _build_error = f"{type(e).__name__}: {e}"
        return False
    return True


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.pt_stat_add.argtypes = [c.c_char_p, c.c_longlong]
    lib.pt_stat_add.restype = None
    lib.pt_stat_set.argtypes = [c.c_char_p, c.c_longlong]
    lib.pt_stat_set.restype = None
    lib.pt_stat_get.argtypes = [c.c_char_p]
    lib.pt_stat_get.restype = c.c_longlong
    lib.pt_stat_reset.argtypes = [c.c_char_p]
    lib.pt_stat_reset.restype = None
    lib.pt_stat_list.argtypes = [c.c_char_p, c.c_int]
    lib.pt_stat_list.restype = c.c_int

    for name in ("pt_prof_enable", "pt_prof_disable", "pt_prof_clear",
                 "pt_prof_pop"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = None
    lib.pt_prof_enabled.argtypes = []
    lib.pt_prof_enabled.restype = c.c_int
    lib.pt_prof_push.argtypes = [c.c_char_p]
    lib.pt_prof_push.restype = None
    lib.pt_prof_add_span.argtypes = [c.c_char_p, c.c_longlong, c.c_longlong]
    lib.pt_prof_add_span.restype = None
    lib.pt_prof_export_chrome.argtypes = [c.c_char_p]
    lib.pt_prof_export_chrome.restype = c.c_int
    lib.pt_prof_summary.argtypes = [c.c_char_p, c.c_int]
    lib.pt_prof_summary.restype = c.c_int
    lib.pt_prof_summary_sorted.argtypes = [c.c_char_p, c.c_char_p, c.c_int]
    lib.pt_prof_summary_sorted.restype = c.c_int

    lib.pd_aes_ctr_crypt.argtypes = [c.c_char_p, c.c_int, c.c_char_p,
                                     c.POINTER(c.c_uint8), c.c_longlong]
    lib.pd_aes_ctr_crypt.restype = c.c_int
    lib.pd_aes_encrypt_block.argtypes = [c.c_char_p, c.c_int, c.c_char_p,
                                         c.POINTER(c.c_uint8)]
    lib.pd_aes_encrypt_block.restype = c.c_int

    lib.pt_feed_create.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_int]
    lib.pt_feed_create.restype = c.c_void_p
    lib.pt_feed_set_files.argtypes = [c.c_void_p, c.c_char_p]
    lib.pt_feed_set_files.restype = None
    lib.pt_feed_load_into_memory.argtypes = [c.c_void_p]
    lib.pt_feed_load_into_memory.restype = c.c_int
    lib.pt_feed_shuffle.argtypes = [c.c_void_p, c.c_ulonglong]
    lib.pt_feed_shuffle.restype = None
    lib.pt_feed_num_samples.argtypes = [c.c_void_p]
    lib.pt_feed_num_samples.restype = c.c_int
    lib.pt_feed_float_dim.argtypes = [c.c_void_p]
    lib.pt_feed_float_dim.restype = c.c_int
    lib.pt_feed_int_dim.argtypes = [c.c_void_p]
    lib.pt_feed_int_dim.restype = c.c_int
    lib.pt_feed_start.argtypes = [c.c_void_p, c.c_int]
    lib.pt_feed_start.restype = None
    lib.pt_feed_next.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p]
    lib.pt_feed_next.restype = c.c_int
    lib.pt_feed_release_memory.argtypes = [c.c_void_p]
    lib.pt_feed_release_memory.restype = None
    lib.pt_feed_destroy.argtypes = [c.c_void_p]
    lib.pt_feed_destroy.restype = None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first call; None when it cannot be
    built or loaded."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not _try_build():
            return None
        try:
            lib = ctypes.CDLL(str(library_path()))
            _declare(lib)
        except (OSError, AttributeError) as e:
            _build_error = f"{type(e).__name__}: {e}"
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native runtime runs (building it on first call); False
    means the pure-Python routes run."""
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (None when it loaded or was not
    tried)."""
    return _build_error


def build_seconds() -> Optional[float]:
    """Seconds this process spent building the library (0.0 when it was
    already built; None before the first use)."""
    return _build_seconds


# ---------------------------------------------------------------- monitor --
# ref platform/monitor.h STAT_ADD/STAT_RESET; pure-python fallback registry.
_py_stats: Dict[str, int] = {}
_py_stats_lock = threading.Lock()


def stat_add(name: str, value: int = 1) -> None:
    lib = get_lib()
    if lib is not None:
        lib.pt_stat_add(name.encode(), int(value))
    else:
        with _py_stats_lock:
            _py_stats[name] = _py_stats.get(name, 0) + int(value)


def stat_set(name: str, value: int) -> None:
    lib = get_lib()
    if lib is not None:
        lib.pt_stat_set(name.encode(), int(value))
    else:
        with _py_stats_lock:
            _py_stats[name] = int(value)


def stat_get(name: str) -> int:
    lib = get_lib()
    if lib is not None:
        return int(lib.pt_stat_get(name.encode()))
    with _py_stats_lock:
        return _py_stats.get(name, 0)


def stat_reset(name: str) -> None:
    lib = get_lib()
    if lib is not None:
        lib.pt_stat_reset(name.encode())
    else:
        with _py_stats_lock:
            _py_stats[name] = 0


def stat_list() -> Dict[str, int]:
    lib = get_lib()
    if lib is None:
        with _py_stats_lock:
            return dict(_py_stats)
    # The registry can grow between the size query and the fill (native
    # worker threads add stats concurrently): retry until the buffer fits.
    need = lib.pt_stat_list(None, 0)
    while True:
        buf = ctypes.create_string_buffer(need + 64)
        got = lib.pt_stat_list(buf, need + 64)
        if got <= need + 63:
            break
        need = got
    out: Dict[str, int] = {}
    for line in buf.value.decode().splitlines():
        if "=" in line:
            k, v = line.rsplit("=", 1)
            out[k] = int(v)
    return out


# --------------------------------------------------------------- profiler --
def prof_enable() -> None:
    lib = get_lib()
    if lib is not None:
        lib.pt_prof_enable()


def prof_disable() -> None:
    lib = get_lib()
    if lib is not None:
        lib.pt_prof_disable()


def prof_enabled() -> bool:
    lib = get_lib()
    return bool(lib and lib.pt_prof_enabled())


def prof_push(name: str) -> None:
    lib = get_lib()
    if lib is not None:
        lib.pt_prof_push(name.encode())


def prof_pop() -> None:
    lib = get_lib()
    if lib is not None:
        lib.pt_prof_pop()


def prof_add_span(name: str, start_ns: int, end_ns: int) -> None:
    lib = get_lib()
    if lib is not None:
        lib.pt_prof_add_span(name.encode(), int(start_ns), int(end_ns))


def prof_clear() -> None:
    lib = get_lib()
    if lib is not None:
        lib.pt_prof_clear()


def prof_export_chrome(path: str) -> int:
    lib = get_lib()
    if lib is None:
        return -1
    return int(lib.pt_prof_export_chrome(path.encode()))


def prof_summary(sorted_key: Optional[str] = None) -> str:
    lib = get_lib()
    if lib is None:
        return ""
    key = (sorted_key or "total").encode()
    # Same grow-and-retry as stat_list: events can land between the size
    # query and the fill.
    need = lib.pt_prof_summary_sorted(key, None, 0)
    while True:
        buf = ctypes.create_string_buffer(need + 256)
        got = lib.pt_prof_summary_sorted(key, buf, need + 256)
        if got <= need + 255:
            return buf.value.decode()
        need = got


# --------------------------------------------------------------- datafeed --
class NativeDataFeed:
    """Python handle on the C++ multi-slot feed engine.

    slots: sequence of (name, dtype, dim) with dtype in {"float32","int64"};
    each produced batch is a dict name -> np.ndarray[batch, dim].
    Mirrors the InMemoryDataset flow (fluid/dataset.py:328):
    set_filelist → load_into_memory → local_shuffle → iterate.
    """

    def __init__(self, slots: Sequence[Tuple[str, str, int]], batch_size: int,
                 capacity: int = 8, num_threads: int = 4):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable ({_build_error})")
        self._lib = lib
        self.slots = [(str(n), str(t), int(d)) for n, t, d in slots]
        for n, _, d in self.slots:
            if ";" in n or ":" in n:
                raise ValueError(f"slot name {n!r} may not contain ';' or ':'")
            if d <= 0:
                raise ValueError(f"slot {n!r} dim must be positive, got {d}")
        self.batch_size = int(batch_size)
        self._epoch_gen = 0
        spec = ";".join(
            f"{n}:{'i' if t in ('int64', 'int32', 'int') else 'f'}:{d}"
            for n, t, d in self.slots)
        self._h = lib.pt_feed_create(spec.encode(), self.batch_size,
                                     int(capacity), int(num_threads))
        if not self._h:
            raise ValueError(f"bad slot spec: {spec!r}")
        self._fdim = lib.pt_feed_float_dim(self._h)
        self._idim = lib.pt_feed_int_dim(self._h)

    def set_filelist(self, files: Sequence[str]) -> None:
        self._lib.pt_feed_set_files(self._h, ";".join(files).encode())

    def load_into_memory(self) -> int:
        n = self._lib.pt_feed_load_into_memory(self._h)
        if n < 0:
            raise IOError("datafeed: failed to read input files")
        return n

    def local_shuffle(self, seed: int = 0) -> None:
        self._lib.pt_feed_shuffle(self._h, int(seed))

    @property
    def num_samples(self) -> int:
        return self._lib.pt_feed_num_samples(self._h)

    def __iter__(self):
        # One live epoch per feed: starting a new iterator restarts the
        # native assembler, so any older iterator must not keep pulling from
        # the reopened queue — it checks its generation token and fails fast.
        self._epoch_gen += 1
        gen = self._epoch_gen
        self._lib.pt_feed_start(self._h, 0)
        fbuf = np.empty((self.batch_size, self._fdim), dtype=np.float32)
        ibuf = np.empty((self.batch_size, self._idim), dtype=np.int64)
        while True:
            if gen != self._epoch_gen:
                raise RuntimeError(
                    "a new epoch was started on this feed; the previous "
                    "iterator is invalid (one live iterator per feed)")
            rows = self._lib.pt_feed_next(
                self._h,
                fbuf.ctypes.data_as(ctypes.c_void_p) if self._fdim else None,
                ibuf.ctypes.data_as(ctypes.c_void_p) if self._idim else None)
            if rows <= 0:
                return
            yield self._split(fbuf[:rows], ibuf[:rows])

    def _split(self, fmat: np.ndarray, imat: np.ndarray):
        out = {}
        foff = ioff = 0
        for name, t, d in self.slots:
            if t in ("int64", "int32", "int"):
                out[name] = imat[:, ioff:ioff + d].copy()
                ioff += d
            else:
                out[name] = fmat[:, foff:foff + d].copy()
                foff += d
        return out

    def release_memory(self) -> None:
        self._lib.pt_feed_release_memory(self._h)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.pt_feed_destroy(h)
