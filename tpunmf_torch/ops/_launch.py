"""Argument checks and launch plumbing shared by the kernel wrappers."""
from __future__ import annotations

import torch

from . import _build

# the rank bound of the update, sweep and scoring kernels, whose shared
# memory holds rows of k accumulators; the objective kernels stage k in
# chunks and take more (fused.OBJECTIVE_MAX_RANK)
MAX_RANK = 1024


def on_cpu(x: torch.Tensor) -> bool:
    """True when the wrapper must take its plain version (x lies on the
    CPU); False for a CUDA tensor; raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {x.device}")


def check_operands(name: str, x, w, h, *extra, max_rank: int,
                   x_dtypes=(torch.float32, torch.bfloat16)):
    """Validate (x, w, h[, extra...]) for a launch of a kernel that takes
    ranks 1..``max_rank`` and X of ``x_dtypes``; returns (m, n, k)."""
    if x.dim() != 2 or w.dim() != 2 or h.dim() != 2:
        raise ValueError(f"{name}: x, w and h must be 2-D")
    m, n = x.shape
    k = w.shape[1]
    if w.shape[0] != m or h.shape != (k, n):
        raise ValueError(f"{name}: shapes x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"h{tuple(h.shape)} do not chain")
    if not 1 <= k <= max_rank:
        raise ValueError(f"{name}: rank k={k} outside [1, {max_rank}]")
    if x.dtype not in x_dtypes:
        raise TypeError(f"{name}: x must be {' or '.join(map(str, x_dtypes))} on CUDA, "
                        f"got {x.dtype} (pass use_pallas=False for the plain route)")
    for t in (x, w, h, *extra):
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for t in (w, h, *extra):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: factors must be float32, got {t.dtype}")
    return m, n, k


def factor_as_x(f, x):
    """Round a factor to X's storage dtype, then compute in the factor's
    (the EU products of the kernels cast the factor to X's dtype first)."""
    return f.to(x.dtype).to(f.dtype) if x.dtype != f.dtype else f


def check_strips(x, bm, bs=None):
    """Raise where ``tpunmf``'s strip height bm (or column block bs) would
    not divide X, as its single-pass wrappers do."""
    m, n = x.shape
    if m % bm:
        raise ValueError(f"bm={bm} must divide m={m} (grid would truncate)")
    if bs is not None and n % bs:
        raise ValueError(f"bs={bs} must divide n={n} (grid would truncate)")


# the single-pass iterations of csrc/wave.cuh, as tpunmf_iteration_scratch counts them:
# MUR KL's FMA waves (above mur_fused.KL_ITER_PAIR_RANK), HALS EU and MUR EU
# (mur_iteration_eu), both on the tensor cores.  The EU pass on TMA and wgmma (the
# "dma" variant, v1_iter, v2_iter and iter_eu_int8) has a query of its own
# (eu_tma_scratch).
WAVE_MUR_KL, WAVE_HALS, WAVE_MUR_EU_TC = 1, 2, 3


def wave_scratch(x, k: int, kind: int) -> torch.Tensor:
    """The float32 scratch a single-pass iteration of ``kind`` needs (its
    length, counted in 64 bits by the C entry, is ``numel()``)."""
    m, n = x.shape
    count = _build.library().tpunmf_iteration_scratch(m, n, k, x.element_size(), kind)
    if count < 0:
        raise ValueError(f"no single-pass iteration of kind {kind}")
    return torch.empty(max(count, 1), dtype=torch.float32, device=x.device)


def call(name: str, device, *args) -> None:
    """Call C entry ``name`` on ``device``'s current stream and check it."""
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(getattr(lib, name)(*args, stream), name)


def tf32_split(f: torch.Tensor):
    """(big, small) of a float32 tensor: big is f rounded to TF32 by
    csrc/tf32x3.cuh's integer rule (add 2^12 to the bits, clear the low 13)
    and small = f - big, exact in f32, so big + small == f."""
    big = ((f.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return big, f - big


def factor_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the EU passes' products take the factors in: X's own, and
    bfloat16 for int8 X (benchmarks/sweep_int8.py:37-45 multiplies in bf16)."""
    return torch.bfloat16 if x.dtype == torch.int8 else x.dtype


def eu_tma_operands(x: torch.Tensor, h: torch.Tensor):
    """H's factor operands for the EU pass on TMA and wgmma
    (csrc/wave.cuh's TmaStages) from H (k, n), f32 or already in the
    factors' dtype (:func:`factor_dtype`), any strides: (f0, f1, ldh),
    (k, ldh) arrays with rows padded by zeros to ldh = n rounded up to 8
    (16-byte rows for TMA).  f32 X: f0 and f1 are H's TF32 big and small
    parts (:func:`tf32_split`); bf16 and int8 X: f0 is H in bf16 and f1 is
    f0 (unused by the kernel)."""
    n = h.shape[1]
    ldh = -(-n // 8) * 8
    hp = torch.nn.functional.pad(h.to(factor_dtype(x)), (0, ldh - n)).contiguous()
    if hp.dtype == torch.bfloat16:
        return hp, hp, ldh
    big, small = tf32_split(hp)
    return big, small, ldh


def eu_tma_scratch(x, k: int) -> torch.Tensor:
    """The float32 scratch of the EU pass on TMA and wgmma (its length,
    counted in 64 bits by the C entry, is ``numel()``)."""
    m, n = x.shape
    count = _build.library().tpunmf_eu_tma_scratch(m, n, k, x.element_size())
    return torch.empty(count, dtype=torch.float32, device=x.device)
