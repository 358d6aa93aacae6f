"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds.  The build runs on first use, into ``build/kernels/`` at the
root of the checkout, keyed by a hash of the flags, the source and the local
headers it includes (``csrc/*.cuh``), so a fresh checkout builds its kernels
itself and an edited header is never served from a stale library.  A failed
build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH)")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: Dict[Path, bytes]) -> Dict[Path, bytes]:
    """``path`` and every file it ``#include "..."``s, recursively, each
    resolved beside the file that names it (as nvcc resolves them)."""
    path = path.resolve()
    if path not in seen:
        seen[path] = path.read_bytes()
        for inc in _LOCAL_INCLUDE.findall(seen[path]):
            _sources(path.parent / inc.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the name plus a hash of the flags,
    the source and every local header it includes."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path, text in sorted(_sources(CSRC / f"{name}.cu", {}).items()):
        digest.update(path.name.encode() + b"\0" + text)
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library for this source exists.
    nvcc's report (ptxas registers, shared memory, spills) is kept beside the
    library as ``.log``."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per process."""
    return ctypes.CDLL(str(build(name)))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        lib.tc_error_string.restype = ctypes.c_char_p
        msg = lib.tc_error_string(ctypes.c_int(err)).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def refuse_autograd(what: str, tensors, todo: str) -> None:
    """Raise if autograd would need a gradient through ``what``: grad mode
    is on and a tensor requires grad.  For a forward-only kernel, whose
    wrapper passes raw pointers, autograd would otherwise lose the gradient
    without an error.  ``todo`` says where its backward stands."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is forward only: call it under torch.no_grad() or "
            f"torch.inference_mode(); its backward is {todo}"
        )


def require_current_device(what: str, tensors, current: Optional[int] = None) -> None:
    """Raise ``ValueError`` unless every CUDA tensor of ``tensors`` lies on
    the current CUDA device (``current``, else ``torch.cuda.
    current_device()``).  The kernels launch through ctypes on the runtime's
    current device: a tensor on another card would fail late, or be read
    and written from the wrong one."""
    for t in tensors:
        index = t.device.index if t.device.type == "cuda" else None
        if index is None:
            continue
        if current is None:
            current = torch.cuda.current_device()
        if index != current:
            raise ValueError(
                f"{what}: a tensor on cuda:{index}, but the current device is cuda:{current}; "
                f"call torch.cuda.set_device({index}) first (a data-parallel rank selects its card)"
            )


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """The card's SM count, asked once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def raw_stream(device: int) -> int:
    """The current stream's handle on the card, through the raw accessor
    (0.2 us a call on the host of an H100 machine): ``torch.cuda.
    current_stream(...).cuda_stream`` took 5.6 us, as long as a bs-8
    stage-4 depthwise-conv launch runs (``scripts/dwconv_probe.py host``)."""
    return torch._C._cuda_getCurrentRawStream(device)
