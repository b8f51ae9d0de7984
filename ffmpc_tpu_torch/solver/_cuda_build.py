"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` has a plain C interface.  At first use every source is
compiled by ``nvcc`` for ``sm_90a`` into ``ffmpc_tpu_torch/_build/``, keyed
by a hash of every file under ``csrc/`` (a source and the headers it
includes) and of the flags, and loaded with ``ctypes``.  The sources are
compiled in parallel, one ``nvcc`` each.  Nothing is built at import.  A
failed build raises; there is no fallback.

``bind`` and ``launch`` are every wrapper's launch path: a C function is
resolved and typed once, and a call costs one ctypes call plus the stream
lookup (``current_stream_handle``, chosen once at import).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, NamedTuple, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_bound: Dict[Tuple[Any, str], Any] = {}


def _find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built on this machine")
    return found


def _target(src: Path) -> Path:
    """The library built from ``src``: its name carries a hash of every file
    under ``csrc/`` (so a changed header gives a new library) and of the
    flags."""
    h = hashlib.sha256()
    h.update(src.name.encode())
    for f in sorted(p for p in CSRC_DIR.rglob("*") if p.is_file()):
        h.update(str(f.relative_to(CSRC_DIR)).encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


class BuildResult(NamedTuple):
    paths: Dict[str, Path]   # source stem -> shared library
    logs: Dict[str, str]     # source stem -> nvcc output (ptxas resource usage)


def build_all() -> BuildResult:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet, one
    ``nvcc`` per source, all started together.  The compiler's output (each
    kernel's registers, shared memory and spills, ``-Xptxas -v``) is kept
    beside the library, so it can be read back whether the library was
    built now or earlier."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {src.stem: _target(src) for src in sources}
    todo = [src for src in sources if not paths[src.stem].exists()]
    if todo:
        nvcc = _find_nvcc()
        running = []
        for src in todo:
            tmp = paths[src.stem].with_suffix(f".tmp{os.getpid()}.so")
            running.append((src, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, tmp, proc in running:
            out = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{out}")
                continue
            paths[src.stem].with_suffix(".log").write_text(out)
            os.replace(tmp, paths[src.stem])
        if failed:
            raise RuntimeError("\n".join(failed))
    logs = {stem: lib.with_suffix(".log").read_text() for stem, lib in paths.items()}
    return BuildResult(paths, logs)


def build_variant(source: Path, defines: Sequence[str] = (), tag: str = "variant") -> Path:
    """The library built from one CUDA source with extra ``-D`` flags (a
    measurement build, or another revision's source), into ``BUILD_DIR``
    beside the package's own libraries.  The source's directory is the
    include path, and every file in it is hashed with the flags, so another
    revision's ``csrc/`` copy builds against its own headers.  The
    compiler's output is kept beside the library (``.log``)."""
    source = Path(source).resolve()
    flags = (*NVCC_FLAGS, *defines)
    h = hashlib.sha256(" ".join(flags).encode() + source.name.encode())
    for f in sorted(p for p in source.parent.iterdir() if p.is_file()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"lib{tag}_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        out = subprocess.run([_find_nvcc(), *flags, "-I", str(source.parent), "-o", str(tmp),
                              str(source)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{out.stdout}")
        lib.with_suffix(".log").write_text(out.stdout)
        os.replace(tmp, lib)
    return lib


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    lib = _libs.get(stem)
    if lib is None:
        paths = build_all().paths
        if stem not in paths:
            raise RuntimeError(f"no CUDA source csrc/{stem}.cu")
        lib = ctypes.CDLL(str(paths[stem]))
        _libs[stem] = lib
    return lib


def bind(lib, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
    """``lib.<symbol>`` with ``argtypes`` and ``restype`` set at its first
    use, cached per (library, symbol): later calls are one dict lookup."""
    key = (lib, symbol)
    fn = _bound.get(key)
    if fn is None:
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _bound[key] = fn
    return fn


if hasattr(torch._C, "_cuda_getCurrentRawStream"):
    def current_stream_handle(index: int) -> int:
        """The ``cudaStream_t`` of device ``index``'s current stream, as
        ``torch.cuda.current_stream(index).cuda_stream`` gives it, without
        building a ``torch.cuda.Stream`` (0.15 against 3.1 us a call on the
        host of an H100, PERF.md)."""
        return torch._C._cuda_getCurrentRawStream(index)
else:  # a PyTorch without the private lookup (and every CPU-only build)
    def current_stream_handle(index: int) -> int:
        """The ``cudaStream_t`` of device ``index``'s current stream."""
        return torch.cuda.current_stream(index).cuda_stream


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call ``fn(*args, stream)`` on ``device``'s current stream and raise
    if the launch was refused (``fn`` returns a cudaError code).  The device
    is made current only when it is not already, so a tensor on another
    card still launches on its own device."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            err = fn(*args, current_stream_handle(device.index))
    else:
        err = fn(*args, current_stream_handle(device.index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
