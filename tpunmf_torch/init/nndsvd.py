"""NNDSVD initialization (Boutsidis & Gallopoulos), vectorised over the rank.

Same contract as ``tpunmf.init.nndsvd`` (reference: nmf/utils.py:36-93):
leading singular triplet taken with absolute values, every further
component picks the positive- or negative-part pair with the larger norm
product, and the 'zero' / 'mean' / 'random' fill variants.  NNDSVD is
invariant to the SVD's per-column sign ambiguity, so the two packages'
SVDs give the same factors.
"""
from __future__ import annotations

import torch

from .random import make_generator


def _nndsvd_from_svd(u, s, vt, x_mean, rank, variant, key=None):
    """Build (w, h) from a truncated SVD. u:(m,r) s:(r,) vt:(r,n)."""
    m = u.shape[0]
    n = vt.shape[1]

    up = torch.clamp(u, min=0.0)
    un = torch.clamp(-u, min=0.0)
    vp = torch.clamp(vt, min=0.0)
    vn = torch.clamp(-vt, min=0.0)

    up_norm = torch.linalg.vector_norm(up, dim=0)
    un_norm = torch.linalg.vector_norm(un, dim=0)
    vp_norm = torch.linalg.vector_norm(vp, dim=1)
    vn_norm = torch.linalg.vector_norm(vn, dim=1)

    norm_pos = up_norm * vp_norm
    norm_neg = un_norm * vn_norm
    take_pos = norm_pos >= norm_neg

    # scale factors; guard 0/0 for all-zero parts (reference would emit nan)
    def _safe_div(a, b):
        return a / torch.where(b == 0.0, torch.ones_like(b), b)

    scale_w_pos = _safe_div(torch.sqrt(s * norm_pos), up_norm)
    scale_w_neg = _safe_div(torch.sqrt(s * norm_neg), un_norm)
    scale_h_pos = _safe_div(torch.sqrt(s * norm_pos), vp_norm)
    scale_h_neg = _safe_div(torch.sqrt(s * norm_neg), vn_norm)

    w = torch.where(take_pos[None, :], scale_w_pos[None, :] * up,
                    scale_w_neg[None, :] * un)
    h = torch.where(take_pos[:, None], scale_h_pos[:, None] * vp,
                    scale_h_neg[:, None] * vn)

    # leading triplet overrides component 0 (reference nmf/utils.py:55-56)
    w[:, 0] = torch.sqrt(s[0]) * torch.abs(u[:, 0])
    h[0, :] = torch.sqrt(s[0]) * torch.abs(vt[0, :])

    if variant == "mean":
        w = torch.where(w == 0.0, x_mean, w)
        h = torch.where(h == 0.0, x_mean, h)
    elif variant == "random":
        g = make_generator(key, w.device)
        rw = torch.rand((m, rank), generator=g, dtype=w.dtype, device=g.device)
        rh = torch.rand((rank, n), generator=g, dtype=h.dtype, device=g.device)
        w = torch.where(w == 0.0, x_mean * rw.to(w.device) / 100.0, w)
        h = torch.where(h == 0.0, x_mean * rh.to(h.device) / 100.0, h)

    return w, h


# 'auto' switches to randomized SVD only beyond this min-dimension, on the
# CPU and on CUDA alike (tpunmf lowers it to 2048 on a TPU only).  The CUDA
# value is the CPU one until a measurement on the card says otherwise
# (ROADMAP.md, queue 1, item 10: the 'auto' rSVD threshold on CUDA).
_AUTO_RSVD_THRESHOLD = 16384


def nndsvd(x, rank=None, variant: str = "zero", key=None, method: str = "auto",
           oversample: int = 10, power_iters: int = 2):
    """SVD-based NMF initialization.

    Args:
      x: (m, n) non-negative data tensor.
      rank: number of components (defaults to n, like the reference).
      variant: 'zero' | 'mean' | 'random' fill for zero entries.
      key: ``torch.Generator`` or int seed for 'random' and randomized SVD.
      method: 'exact' (torch.linalg.svd), 'randomized', or 'auto'.
    """
    if rank is None:
        rank = x.shape[1]

    if method == "auto":
        method = "randomized" if min(x.shape) > _AUTO_RSVD_THRESHOLD else "exact"

    if method == "randomized":
        from .rsvd import randomized_svd

        u, s, vt = randomized_svd(x, rank, key=key, oversample=oversample,
                                  power_iters=power_iters)
    else:
        u, s, vt = torch.linalg.svd(x, full_matrices=False)
        u = u[:, :rank]
        s = s[:rank]
        vt = vt[:rank, :]

    return _nndsvd_from_svd(u, s, vt, torch.mean(x), rank, variant, key)
