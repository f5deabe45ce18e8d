"""Build and load the port's hand-written CUDA kernels.

Each kernel package keeps its sources in ``csrc/`` and registers one shared
library per ``csrc/<name>.cu`` with :func:`register`, together with the
function that declares its C entry points to ``ctypes``.  :func:`build_all`
compiles every library that is not built yet with ``nvcc`` for ``sm_90a`` —
one compiler process per source, all started together — into the
git-ignored ``build/`` directory beside the package's sources, and loads
each library once per process.  Nothing is compiled or loaded when a module
is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, NamedTuple

__all__ = ["NVCC_FLAGS", "SMEM_LIMIT", "register", "build_all", "build",
           "registered", "ptxas_entries", "count_launch"]

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# dynamic shared memory one block may use on Hopper (bytes)
SMEM_LIMIT = 232448


class _Library(NamedTuple):
    csrc: Path                          # directory of the sources
    bind: Callable[[ctypes.CDLL], None]


_REGISTRY: dict[str, _Library] = {}
_loaded: dict[str, ctypes.CDLL] = {}
# builds and launch counts may come from several host threads at once (a
# simulator grid split over devices runs a thread per device; shard_map
# ranks run a thread each, their backward in autograd's device thread)
_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, attr: str = "launches") -> None:
    """Add one to ``wrapper.<attr>``, a launch count of a kernel wrapper,
    under a lock."""
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def register(name: str, csrc: Path, bind: Callable[[ctypes.CDLL], None]
             ) -> None:
    """Declare the library built from ``csrc/<name>.cu``; ``bind`` sets the
    argument and return types of its C functions."""
    _REGISTRY[name] = _Library(Path(csrc), bind)


def registered() -> tuple[str, ...]:
    """Names of every registered library, in registration order."""
    return tuple(_REGISTRY)


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def _tag(name: str) -> str:
    """Hash of everything the library is compiled from: its source, the
    headers beside it and the compiler flags."""
    h = hashlib.sha1(name.encode() + " ".join(NVCC_FLAGS).encode())
    for path in sorted(_REGISTRY[name].csrc.glob("*.cu*")):
        h.update(path.name.encode() + path.read_bytes())
    return h.hexdigest()[:12]


def build_all(names=None) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile the named libraries (default: every registered one) that
    are not built yet and load them.  A library is compiled once per
    version of its sources (its file name carries :func:`_tag`) and loaded
    once per process.  Returns ``{name: (library, compiler log)}``; a log
    holds ptxas's register, spill and shared-memory report of the build
    that made the library (kept beside it as ``<library>.log``)."""
    names = tuple(_REGISTRY) if names is None else tuple(names)
    unknown = [n for n in names if n not in _REGISTRY]
    if unknown:
        raise KeyError(f"unknown kernel libraries {unknown}; have "
                       f"{tuple(_REGISTRY)}")
    with _BUILD_LOCK:
        return _build_locked(names)


def _build_locked(names) -> dict[str, tuple[ctypes.CDLL, str]]:
    todo = [name for name in names if name not in _loaded]
    paths, jobs, logs = {}, {}, {}
    for name in todo:
        src = _REGISTRY[name].csrc
        build_dir = src.parent / "build"
        build_dir.mkdir(parents=True, exist_ok=True)
        so = paths[name] = build_dir / f"{name}_{_tag(name)}.so"
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, so)
    failed = []
    for name, (proc, tmp, so) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            so.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(
            f"{n}.cu:\n{logs[n]}" for n in failed))
    for name in todo:
        lib = ctypes.CDLL(str(paths[name]))
        _REGISTRY[name].bind(lib)
        _loaded[name] = lib
        log = paths[name].with_suffix(".log")
        if name not in logs and log.exists():
            logs[name] = log.read_text()
    return {name: (_loaded[name], logs.get(name, "")) for name in names}


def build(name: str) -> tuple[ctypes.CDLL, str]:
    """The loaded library ``name``, compiled first if need be.  Returns
    ``(library, compiler log)``."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib, ""
    return build_all((name,))[name]


def ptxas_entries(log: str) -> dict[str, dict[str, int]]:
    """What ptxas's ``-v`` report in a build log says of each entry
    function (by its mangled name): ``registers`` a thread, ``stack``
    frame, ``spill_stores`` and ``spill_loads`` bytes, and static ``smem``
    bytes (dynamic shared memory is the launch's and is not in the
    report)."""
    out: dict[str, dict[str, int]] = {}
    parts = re.split(r"Compiling entry function '([^']+)'", log)
    for name, body in zip(parts[1::2], parts[2::2]):
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", body)
        regs = re.search(r"Used (\d+) registers", body)
        smem = re.search(r"(\d+) bytes smem", body)
        if not (frame and regs):
            continue
        out[name] = dict(registers=int(regs.group(1)),
                         stack=int(frame.group(1)),
                         spill_stores=int(frame.group(2)),
                         spill_loads=int(frame.group(3)),
                         smem=int(smem.group(1)) if smem else 0)
    return out
