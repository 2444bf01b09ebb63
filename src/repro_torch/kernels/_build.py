"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/<name>-<hash>.so``
under the checkout's root (a directory ``.gitignore`` lists), compiled for
``sm_90a`` at first use.  The hash covers the sources, the shared headers
and the flags, so an edit rebuilds and an unchanged tree reuses the
library.  Several processes may build at once (the ranks of a spawned
job): :func:`build` holds a file lock on the build directory, so one of
them compiles and the others find its libraries, and each library and
its ptxas report are written under a temporary name and renamed into
place.  The C entries take pointers and the stream as ``c_void_p`` and
return ``cudaGetLastError()``.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argtypes of each library's one C entry (see the .cu files)
ENTRIES = {
    "coarse_commit": ("aam_coarse_commit",
                      [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I,
                       _P]),
    "fused_wave": ("aam_fused_route_commit",
                   [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                    _I, _I, _P]),
    "coalesce": ("aam_bucket_count", [_P, _P, _L, _I, _P]),
    "ssd_chunk": ("aam_ssd_chunk",
                  [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P]),
}

SOURCES = tuple(ENTRIES)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) \
        / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _locked():
    """The build directory's lock, held by one process at a time."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` not built yet, one ``nvcc`` per
    source, all started together.  Returns ``{name: ptxas report}`` for
    the ones this call compiled; raises with the compiler's output on
    failure.  Safe to call from several processes at once."""
    with _locked():
        return _build_unlocked(names)


def _build_unlocked(names) -> dict[str, str]:
    procs = {}
    try:
        for name in names:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        reports, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
            # the report first: a library that exists has its report
            report = out.with_suffix(".ptxas.txt")
            tmp_report = report.with_suffix(f".{os.getpid()}.tmp")
            tmp_report.write_text(log)
            os.replace(tmp_report, report)
            os.replace(tmp, out)
            reports[name] = log
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` said when ``csrc/<name>.cu`` was built: each
    kernel's registers, shared memory and spills.  Builds it if needed."""
    build((name,))
    return _target(name).with_suffix(".ptxas.txt").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)))
        entry, argtypes = ENTRIES[name]
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.aam_error_string.argtypes = [ctypes.c_int]
        lib.aam_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry of ``lib`` reported a CUDA error."""
    if err != 0:
        msg = lib.aam_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
