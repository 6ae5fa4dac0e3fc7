"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

The sources are compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``: one
``nvcc -c`` per ``.cu`` file, all started together, then one link.  The
library's file name carries a hash of the sources and flags, so a changed
``.cu`` or ``.cuh`` file builds a new library; the build directory
(``ops/_build/``) is not committed.  Fast-math is deliberately off: the KL
kernels depend on IEEE ``logf``, division and denormals for their inf/NaN
masking.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).with_name("csrc")
_BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each entry point (all return cudaGetLastError() as int)
_SIGNATURES = {
    # x, x_is_bf16, w, h, aux (Gh or rowsum H), lam, m, n, k, is_kl, out, stream
    "tpunmf_mur_w_update": (_P, _I, _P, _P, _P, _F, _I, _I, _I, _I, _P, _P),
    # x, x_is_bf16, w, h, hsum, lam, m, n, k, out, partials, obj, stream
    "tpunmf_mur_w_update_lagged": (_P, _I, _P, _P, _P, _F, _I, _I, _I, _P, _P, _P, _P),
    # m, k -> length of the partials buffer tpunmf_mur_w_update_lagged needs
    "tpunmf_mur_w_lagged_blocks": (_I, _I),
    # x, x_is_bf16, w, h, aux (Gw or colsum W), lam, m, n, k, is_kl,
    # h_out, numer_out, stream
    "tpunmf_mur_h_update": (_P, _I, _P, _P, _P, _F, _I, _I, _I, _I, _P, _P, _P),
    # a, a strides (2), g, v, v strides (2), lam, k, cols, nsweeps,
    # out, out strides (2), stream
    "tpunmf_gs_sweep": (_P, _I, _I, _P, _P, _I, _I, _F, _I, _I, _I, _P, _I, _I, _P),
    # x, x_is_bf16, mask, mask_is_byte, w, h, lam, m, n, k, is_kl, out, stream
    "tpunmf_masked_w_update": (_P, _I, _P, _I, _P, _P, _F, _I, _I, _I, _I, _P, _P),
    "tpunmf_masked_h_update": (_P, _I, _P, _I, _P, _P, _F, _I, _I, _I, _I, _P, _P),
    # x, x_is_bf16, w, h, m, n, k, is_kl, partials, out, stream
    "tpunmf_objective": (_P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    # m, n -> length of the partials buffer tpunmf_objective needs
    "tpunmf_objective_blocks": (_I, _I),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently; raise if any fails, else return
    their standard errors (ptxas's register and shared-memory report)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{out}\n{err}")
    return [err for _, err in outs]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` if needed."""
    lib_path = _BUILD_DIR / f"libtpunmf_kernels_{_digest()}.so"
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
            srcs = sorted(_CSRC.glob("*.cu"))
            objs = [os.path.join(tmp, f"{p.stem}.o") for p in srcs]
            reports = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                                for p, o in zip(srcs, objs)])
            so = os.path.join(tmp, lib_path.name)
            _run_all([[nvcc, "-shared", "-o", so, *objs]])
            (_BUILD_DIR / f"{lib_path.stem}.ptxas.txt").write_text("".join(reports))
            os.replace(so, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")
