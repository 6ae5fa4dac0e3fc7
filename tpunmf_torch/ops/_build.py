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

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signature of each entry point (each returns cudaGetLastError() or a
# count as int, or the type _RESULTS gives)
_SIGNATURES = {
    # x, x_is_bf16, w, h (EU: in X's type), ldh (h's row stride), aux (Gh or
    # rowsum H), lam, m, n, k, is_kl, splits (KL), scratch, scratch_len
    # (floats, 64-bit), out, stream
    "tpunmf_mur_w_update": (_P, _I, _P, _P, _I, _P, _F, _I, _I, _I, _I, _I, _P, _L, _P, _P),
    # x, x_is_bf16, w, h, ldh, hsum, lam, m, n, k, splits, scratch,
    # scratch_len, out, partials, obj, stream
    "tpunmf_mur_w_update_lagged": (_P, _I, _P, _P, _I, _P, _F, _I, _I, _I, _I, _P, _L, _P, _P,
                                   _P, _P),
    # m, k, splits -> length of the partials buffer
    # tpunmf_mur_w_update_lagged needs
    "tpunmf_mur_w_lagged_blocks": (_I, _I, _I),
    # m, n, k, x_bytes -> floats of scratch the EU W pass needs (64-bit)
    "tpunmf_mur_w_eu_scratch": (_I, _I, _I, _I),
    # x, x_is_bf16, w, h, aux (Gw or colsum W), lam, m, n, k, is_kl, part
    # (splits * k * n floats where splits > 1), splits, h_out, numer_out,
    # stream
    "tpunmf_mur_h_update": (_P, _I, _P, _P, _P, _F, _I, _I, _I, _I, _P, _I, _P, _P, _P),
    # x, x_is_bf16, w, hc (H in X's type), gh, lam, m, n, k, w_out, wtx,
    # gram, scratch, dma, stream
    "tpunmf_mur_iteration_eu": (_P, _I, _P, _P, _P, _F, _I, _I, _I, _P, _P, _P, _P, _I, _P),
    # x, x_is_bf16, w, h, hsum, lam, m, n, k, w_out, wtr, obj, scratch, stream
    "tpunmf_mur_iteration_kl": (_P, _I, _P, _P, _P, _F, _I, _I, _I, _P, _P, _P, _P, _P),
    # x, x_is_bf16, w, hc (H in X's type), hht, lam, m, n, k, nsweeps,
    # w_out, wtx, gram, scratch, stream
    "tpunmf_hals_iteration_eu": (_P, _I, _P, _P, _P, _F, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # m, n, k, x_bytes (X's element size), kind (0 MUR EU and its variants,
    # 1 MUR KL, 2 HALS) -> floats of scratch the single-pass iteration needs
    "tpunmf_iteration_scratch": (_I, _I, _I, _I, _I),
    # x, x_is_bf16, ht (H^T (n, k) in X's type), w, gh, m, n, k, w_out,
    # wtx, gram, scratch, stream
    "tpunmf_v1_iter": (_P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P),
    # x, x_is_bf16, ht, h, w, gh, m, n, k, w_out, h_out, wtx, gram,
    # scratch, stream
    "tpunmf_v2_iter": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    # xq (int8), h, w, gh, scale (device float), m, n, k, w_out, wtx, gram,
    # scratch, stream
    "tpunmf_iter_eu_int8": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P),
    # x, s (device float), m, n, out, stream
    "tpunmf_read_probe": (_P, _P, _I, _I, _P, _P),
    # a, a strides (2), g, v, v strides (2), lam, k, cols, nsweeps,
    # out, out strides (2), stream
    "tpunmf_gs_sweep": (_P, _I, _I, _P, _P, _I, _I, _F, _I, _I, _I, _P, _I, _I, _P),
    # x, x_is_bf16, mask, mask_is_byte, w, h, ldh (h's row stride), lam, m,
    # n, k, is_kl, block_rows (64 or 32), out, stream
    "tpunmf_masked_w_update": (_P, _I, _P, _I, _P, _P, _I, _F, _I, _I, _I, _I, _I, _P, _P),
    # x, x_is_bf16, mask, mask_is_byte, w, h, lam, m, n, k, is_kl, part
    # (2 * splits * k * n floats), splits, out, stream
    "tpunmf_masked_h_update": (_P, _I, _P, _I, _P, _P, _F, _I, _I, _I, _I, _P, _I, _P, _P),
    # x, x_is_bf16, w, h, m, n, k, is_kl, partials, out, stream
    "tpunmf_objective": (_P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    # m, n -> length of the partials buffer tpunmf_objective needs
    "tpunmf_objective_blocks": (_I, _I),
    # m, n -> length of the partials buffer tpunmf_kl_ratio_obj needs
    "tpunmf_ratio_blocks": (_I, _I),
    # x, x_is_bf16, w, h, m, n, k, eps, ratio, partials, out, stream
    "tpunmf_kl_ratio_obj": (_P, _I, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P),
    # x, x_is_bf16, w, h, m, n, k, eps, ratio, stream
    "tpunmf_kl_ratio": (_P, _I, _P, _P, _I, _I, _I, _F, _P, _P),
    # scores, dtype (0 f32, 1 bf16, 2 f64), b, n, nbp, sel, bmax, s3 (NULL
    # where s3 is a view of the scores), stream
    "tpunmf_blockmax_relayout": (_P, _I, _I, _I, _I, _I, _P, _P, _P),
    # w (f32), h, h dtype (0 f32, 1 bf16, 2 f16), b, r, n, nbp, sel, bmax,
    # s3, stream
    "tpunmf_score_blockmax": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
}
# entry points whose result is not an int
_RESULTS = {"tpunmf_mur_w_eu_scratch": _L}


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
        fn.restype = _RESULTS.get(name, _I)
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")
