"""Build and load the native host runtime (``native/bleu.cpp``,
``native/dataloader.cpp`` beside this file) through ctypes (counterpart of
``tpu_captioner/native/lib.py``).

The two sources compile with ``g++ -O3 -std=c++17 -fPIC -shared -pthread``
into one shared library on first use, into ``build/native/`` at the root of
the checkout, keyed by a hash of the flags and the sources, as
``ops/_build.py`` keys the kernels: an edited source is never served from a
stale library.  The compiler writes to a temporary name that is renamed into
place, so processes that build at once each load a whole library.

Departure from the JAX package: there, a missing toolchain or a failed build
falls back to pure Python without a word.  Here a failed build or load
raises with the compiler's stderr, and no caller falls back.  The
pure-Python scorer (``eval/bleu.py``) and numpy's fancy indexing stay as the
plain versions the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
SOURCES = ("bleu.cpp", "dataloader.cpp")
COMPILER = "g++"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


def library_path() -> Path:
    """Where the sources build to: a hash of the flags and the sources."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode() + b"\0" + (SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libtcnative-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; raise with the
    compiler's stderr if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [COMPILER, *FLAGS, "-o", tmp, *(str(SRC_DIR / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run {COMPILER!r} to build the native runtime: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{COMPILER} failed to build the native runtime (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process, with the
    entry points' argument types declared."""
    lib = ctypes.CDLL(str(build()))
    c = ctypes
    i32, i64 = c.POINTER(c.c_int32), c.POINTER(c.c_int64)
    lib.corpus_bleu_stats.argtypes = [i32, i64, c.c_int64, i32, i64, i64, c.c_int, i64, i64, i64, i64]
    lib.corpus_bleu_stats.restype = None
    lib.gather_batch.argtypes = [
        c.POINTER(c.c_uint8), c.c_int64, i32, i32, c.c_int64, i64, i64, c.c_int64,
        c.POINTER(c.c_uint8), i32, i32, c.c_int,
    ]
    lib.gather_batch.restype = None
    return lib


def ptr(arr, ctype):
    """``arr``'s data as a ctypes pointer to ``ctype``."""
    return arr.ctypes.data_as(ctypes.POINTER(ctype))
