"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  The sources
compile in parallel, one nvcc each, then link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu       # per source
    nvcc -shared -o _build/libwrf_tpu_torch_<hash>.so *.o

The library lands in ``wrf_tpu_torch/_build/`` (git-ignored) at first use,
named by a hash of the sources and flags, so a fresh checkout builds it
once and a source change rebuilds it.  ``-fmad=false`` keeps the compiler
from contracting multiplies and adds, the reference CUDA build's policy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_loaded: dict[Path, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location; raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels are built from wrf_tpu_torch/csrc at first use")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libwrf_tpu_torch_{h.hexdigest()[:16]}.so"


def build(ptxas_info: bool = False) -> tuple[Path, str]:
    """Compile the kernels unless the library for these sources exists.

    Returns ``(library path, compiler log)``; with ``ptxas_info`` the log
    holds each kernel's registers, shared memory and spills (it is empty
    when the library was already built)."""
    out = library_path()
    if out.exists() and not ptxas_info:
        return out, ""
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    objdir = out.with_name(f"{out.stem}.{os.getpid()}.objs")
    objdir.mkdir()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        jobs = []
        for src in (s for s in sources() if s.suffix == ".cu"):
            obj = objdir / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS,
                   *(("-Xptxas", "-v") if ptxas_info else ()),
                   "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        # wait for every compile, then report the first failure
        logs = [(cmd, proc, proc.communicate()[0]) for cmd, _, proc in jobs]
        for cmd, proc, text in logs:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                                   f"{' '.join(cmd)}\n{text}")
        log = "".join(text for _, _, text in logs)
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(objdir, ignore_errors=True)
    return out, log + proc.stdout + proc.stderr


def load() -> ctypes.CDLL:
    """The kernel library for the current sources, built on first use."""
    path, _ = build()
    if path not in _loaded:
        _loaded[path] = ctypes.CDLL(str(path))
    return _loaded[path]
