"""Build the port's CUDA kernels with ``nvcc``, bind them with ctypes, and
count their runs on the card (``kernel_runs``).

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own
``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface.  The library goes to
``src/repro_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the sources and flags, so a checkout builds once at first use and an
edited source builds anew.  No source includes PyTorch's headers: the
build takes seconds, not minutes.

The flags keep ``-O3`` and leave out ``--use_fast_math``: approximate
``sqrt`` and division flip silhouette pixels in the render kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

from repro_torch import obs

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "render_score_sums_launch": [_P] * 5 + [_I] * 4 + [_F] * 2 + [_P],
    "render_score_max_active_clusters": [_I] * 2,
    "pso_update_launch": [_P] * 10 + [_I] * 5 + [_F] * 4 + [_P],
    "delta_encode_launch": [_P] * 6 + [_I] * 5 + [_F, _P],
    "delta_decode_launch": [_P] * 4 + [_I, _P],
    "quantize_pack_launch": [_P] * 3 + [_I] * 2 + [_F] * 3 + [_P],
    "unpack_dequantize_launch": [_P] * 2 + [_I] * 2 + [_F] * 2 + [_P],
    "significant_bit_widths_launch": [_P] * 2 + [_I] * 5 + [_P],
    "quant_encode_launch": [_P] * 4 + [_I] * 5 + [_F] * 4 + [_P],
    "quant_decode_launch": [_P] * 4 + [_I] * 7 + [_F] * 2 + [_P],
}

_library: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or the
    toolkit's usual prefix.  Raises if there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built"
    )


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> pathlib.Path:
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    return BUILD_DIR / f"repro_torch_kernels_{digest.hexdigest()[:16]}.so"


def build_log_path() -> pathlib.Path:
    """Where the last build of this source set left nvcc's output
    (including ``-Xptxas -v``'s registers and spills per kernel)."""
    return library_path().with_suffix(".log")


def build() -> pathlib.Path:
    """Compile the library if this source set has not been built yet
    (the span ``kernels.build``, counted as ``kernels.builds``); return
    its path.  Raises with nvcc's output if a compile fails."""
    target = library_path()
    if target.exists():
        return target
    with obs.span("kernels.build"):
        _compile(target)
    obs.count("kernels.builds")
    return target


def _compile(target: pathlib.Path) -> None:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        jobs = []
        for src in sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _obj, proc in jobs:  # wait for every job, even after a failure
            out, _ = proc.communicate()
            log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_so = work / target.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so)]
            + [str(obj) for _src, obj, _p in jobs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        target.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp_so, target)  # atomic: concurrent builds agree
    finally:
        shutil.rmtree(work, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The built kernels, loaded once per process."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_torch_error_string.argtypes = [ctypes.c_int]
        lib.repro_torch_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library().repro_torch_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err} ({msg})")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C side takes it."""
    return torch.cuda.current_stream(device).cuda_stream


def kernel_input(name: str, t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A kernel argument as the kernels take it: on ``device``, float32
    (other float types are upcast, as the reference does), contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_floating_point():
        raise TypeError(f"{name} has dtype {t.dtype}, expected a float tensor")
    return t.to(torch.float32).contiguous()


def kernel_runs(fn, names):
    """Call ``fn()`` under ``torch.profiler`` and count, from the card's
    own records, the kernels it ran whose names hold each of ``names``:
    eager launches and a CUDA graph's replays alike (a wrapper's count
    sees a graph's launches only at its capture).  Returns (fn's result,
    {name: runs})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    runs = dict.fromkeys(names, 0)
    # the raw records: a clip's graph replays make 1e5 of them
    for event in prof.profiler.kineto_results.events():
        if event.device_type() == DeviceType.CUDA:
            for name in names:
                runs[name] += name in event.name()
    return out, runs
