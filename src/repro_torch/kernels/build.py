"""Build the CUDA kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (pointers, ints, floats,
the stream and a ``dtype`` code from :data:`DTYPE_CODES`; it returns the
launch's ``cudaError_t``) and compiles on its own with ``nvcc`` into
``build/kernels/<name>-<hash>.so`` at the repository root; the hash covers
the source, every ``csrc`` header it includes (directly or through another
header) and its flags, so an edit to any of them rebuilds and an unchanged
tree is reused.  Nothing is built when a module is imported:
the kernel wrappers call :func:`load` at their first launch, and
``chip_smoke.py`` calls :func:`build` up front to build every kernel in
parallel (one ``nvcc`` per source, all started together).  A failed build
raises with the compiler's output.  :func:`ptxas_report` and
:func:`sass_counts` read back what was built: registers, spills and shared
memory per function, and how many of given SASS instructions each holds.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["KERNELS", "CSRC", "BUILD_DIR", "NVCC_FLAGS", "EXTRA_FLAGS",
           "DTYPE_CODES", "build", "load", "library_path", "sources", "flags",
           "ptxas_report", "sass_counts", "aligned"]

KERNELS = ("flash_attention", "paged_attention", "gossip_mix", "ssd_scan")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags one kernel adds to NVCC_FLAGS (an include path, a define); none yet
EXTRA_FLAGS: dict[str, tuple[str, ...]] = {}

# the ``dtype`` argument of every kernel's C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every header of ``csrc`` it includes, directly
    or through another header (system headers are the toolkit's)."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = path.parent / inc.decode()
            if header.exists():
                todo.append(header)
    return found


def flags(name: str) -> tuple[str, ...]:
    return (*NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for path in sorted(sources(name)):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Build every kernel in ``names`` whose library is missing, all in
    parallel.  Returns seconds per kernel (0.0 for one already built); the
    compiler's report (registers, shared memory, spills) is kept beside
    each library as ``<name>-<hash>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    procs = {}
    t0 = time.perf_counter()
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    seconds = {n: 0.0 for n in names}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)        # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def _demangle(names: list[str]) -> list[str]:
    cxxfilt = shutil.which("c++filt")
    if not cxxfilt or not names:
        return names
    out = subprocess.run([cxxfilt], input="\n".join(names), text=True,
                         capture_output=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def ptxas_report(name: str) -> list[dict]:
    """Per function of kernel ``name``'s library, from the ``ptxas -v`` log
    kept beside it: registers, spill stores and loads (bytes) and static
    shared memory (bytes; dynamic shared memory is the launch's)."""
    rows, cur = [], None
    for line in library_path(name).with_suffix(".log").read_text().splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            cur = {"function": m.group(1), "registers": None,
                   "spill_stores": 0, "spill_loads": 0, "smem_bytes": 0}
            rows.append(cur)
        elif cur is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        elif cur is not None and (m := re.search(r"Used (\d+) registers",
                                                 line)):
            cur["registers"] = int(m.group(1))
            if s := re.search(r"(\d+) bytes smem", line):
                cur["smem_bytes"] = int(s.group(1))
    for row, pretty in zip(rows, _demangle([r["function"] for r in rows])):
        row["function"] = pretty
    return rows


def _cuobjdump() -> str | None:
    found = shutil.which("cuobjdump")
    if found:
        return found
    candidates = [Path("/usr/local/cuda/bin/cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:       # the copy Triton ships, without importing it
        candidates.append(Path(spec.origin).parent / "backends" / "nvidia"
                          / "bin" / "cuobjdump")
    return next((str(c) for c in candidates if c.exists()), None)


def sass_counts(name: str, opcodes=("HGMMA", "UTMALDG")) -> dict[str, dict]:
    """How many instructions of each opcode every function of kernel
    ``name``'s built library holds, from ``cuobjdump -sass``."""
    tool = _cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump not found (CUDA toolkit or Triton's copy)")
    sass = subprocess.run([tool, "-sass", str(library_path(name))], text=True,
                          capture_output=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            cur = counts.setdefault(m.group(1), dict.fromkeys(opcodes, 0))
        elif cur is not None:
            for op in opcodes:
                cur[op] += bool(re.search(rf"\b{op}\b", line))
    names = list(counts)
    return dict(zip(_demangle(names), counts.values()))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _LOADED:
        build((name,))
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]


def aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned, as the kernels' vector loads
    need (a copy only when it is not already)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()
