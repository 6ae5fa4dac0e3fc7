"""BASELINE.json's five configurations, each run to convergence and held to
the port's float64 plain route.

The counterpart of ``tpunmf``'s benchmarks/run_configs.py, run on a CUDA
card (or, with ``--device cpu``, on the CPU):

    python -m tpunmf_torch.sweeps.run_configs [--scale 0.1] [--out report.json]
        [--configs 0,1,2,3,4] [--newsgroups-root DIR] [--movielens-path FILE]
        [--max-iter-cap N] [--device cuda|cpu]

  config0  MUR Euclidean, dense synthetic                  (final error)
  config1  MUR KL, tf-idf-like term-doc matrix             (final KL)
  config2  ANLS + FCNNLS, recommender matrix + recall@10   (final error, recall)
  config3  ADMM, L1 on H, sparse matrix                    (final error at fixed
           rho, a 25-iteration trajectory; adaptive-rho convergence)
  config4  AO-ADMM KL, mixed W/H regularizers, over a mesh (final KL; the mesh
           run against one device)

The script's yardstick is the numpy reference package.  Here it is the
port's plain route at float64 on the same device (a float64 tensor is how a
caller asks for it), which the CPU tests hold to ``tpunmf`` at float64.
"Ours" is the default route in ``dtype`` (float32: the kernel route on the
card); beside it, ``plain_f32`` is the plain route at float32, the control.
Each config computes NNDSVD 'zero' once, in float64 on the device, and
passes it to every route in that route's dtype: the script gives ours and
its reference ``nndsvd_init=(True, "zero")``, and at float64 the two give
the same bits.  Errors and KL divergences are computed in float64 on the
device, a block of rows at a time.  The data are the script's: the same
generators and seeds (float32 matrices cast up exactly, as the script's
``np.asarray(..., dtype=np.float64)`` does).
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import sys
import time

import numpy as np
import torch

from ..core.losses import distance
from ..core.precision import full_f32
from ..data import densify, lowrank_dense, movielens_like, sparse_csr, tfidf_like
from ..init import nndsvd
from ..serve.topk import recall_at_k, topk_scores_dense
from ..solvers import admm, anls, ao_admm, mur

# BASELINE.json's target: <= 1e-4 relative deviation of the final error
GATE = 1e-4
# rows of X a block of the float64 errors takes
ROWS = 4096


def capped(kw, cap):
    """``kw`` with min_iter and max_iter at most ``cap`` (--max-iter-cap)."""
    if cap is not None:
        kw = dict(kw, max_iter=min(kw["max_iter"], cap), min_iter=min(kw["min_iter"], cap))
    return kw


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _factors(res, device):
    return (torch.as_tensor(np.asarray(res.w)).to(device),
            torch.as_tensor(np.asarray(res.h)).to(device))


@full_f32()
def rel_err(x, w, h) -> float:
    """||X - W H||_F / ||X||_F in float64 on X's device."""
    hd = h.double()
    num = den = torch.zeros((), dtype=torch.float64, device=x.device)
    for r in range(0, x.shape[0], ROWS):
        xb = x[r:r + ROWS].double()
        num = num + torch.sum((xb - w[r:r + ROWS].double() @ hd) ** 2)
        den = den + torch.sum(xb * xb)
    return math.sqrt(float(num) / float(den))


@full_f32()
def kl_f64(x, w, h) -> float:
    """The KL objective of (W, H) on X (core/losses.py's formula) in float64
    on X's device."""
    hd = h.double()
    return float(sum(distance(x[r:r + ROWS].double(), w[r:r + ROWS].double() @ hd, "kl")
                     for r in range(0, x.shape[0], ROWS)))


def deviation(got, want) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def init_f64(x, k):
    """NNDSVD 'zero' of X in float64 on X's device, and its seconds."""
    _sync(x.device)
    t0 = time.perf_counter()
    w, h = nndsvd(x.double(), k, variant="zero")
    _sync(x.device)
    return (w, h), time.perf_counter() - t0


def _route(fit, x, k, init, dtype, kw, use_pallas=None):
    """``fit`` on X and the init cast to ``dtype``: (Results, seconds).  Its
    m x n state is freed before it returns."""
    xr = x.to(dtype)
    w0, h0 = (f.to(dtype) for f in init)
    _sync(x.device)
    t0 = time.perf_counter()
    res = fit(xr, k, w_init=w0, h_init=h0, use_pallas=use_pallas, **kw)
    _sync(x.device)
    seconds = time.perf_counter() - t0
    del xr, w0, h0
    if x.device.type == "cuda":
        torch.cuda.empty_cache()
    return res, seconds


def _routes(fit, x, k, init, kw, dtype):
    """(ours, ref, plain): ``fit`` from ``init`` on the default route in
    ``dtype``, on the plain route in float64 (the yardstick) and on the
    plain route in float32 (the control); each (Results, seconds)."""
    return (_route(fit, x, k, init, dtype, kw),
            _route(fit, x, k, init, torch.float64, kw, use_pallas=False),
            _route(fit, x, k, init, torch.float32, kw, use_pallas=False))


def _scored(out, name, value, ours, ref, plain):
    """The script's keys for ours against the reference (``name``,
    ``ref_<name>``, ``final_err_deviation``, ``iters_match``) and the plain
    f32 route's record; ``value(res)`` scores a run."""
    (o, o_s), (r, r_s), (p, p_s) = ours, ref, plain
    ref_v = value(r)
    out.update({"i": o.i, name: value(o), "wall_s": round(o_s, 3), "ref_i": r.i,
                f"ref_{name}": ref_v, "ref_wall_s": round(r_s, 3)})
    out["final_err_deviation"] = deviation(out[name], ref_v)
    out["iters_match"] = o.i == r.i
    pv = value(p)
    out["plain_f32"] = {"i": p.i, name: pv, "final_err_deviation": deviation(pv, ref_v),
                        "wall_s": round(p_s, 3)}
    return out


def _on(x, device):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _given(x, shape, config):
    """``x``, the config's matrix the caller already holds on the device,
    checked against the scale rule's shape."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{config}: x is {tuple(x.shape)}, the scale gives {tuple(shape)}")
    return x


def _header(config, x, k, init_s):
    return {"config": config, "shape": [int(x.shape[0]), int(x.shape[1]), k],
            "init_s": round(init_s, 3)}


def config0_mur_eu(scale, *, device="cuda", dtype=torch.float32, cap=None):
    """MUR EU on lowrank_dense (run_configs.py:72-96)."""
    device = torch.device(device)
    m, n, k = max(64, int(2000 * scale)), max(48, int(1000 * scale)), 20
    x = _on(lowrank_dense(m, n, k, seed=0, dtype=np.float64), device)
    kw = capped(dict(distance_type="eu", min_iter=20, max_iter=500, tol1=1e-6, tol2=1e-6),
                cap)
    init, init_s = init_f64(x, k)
    out = _header("MUR-EU dense", x, k, init_s)
    return _scored(out, "rel_err", lambda r: rel_err(x, *_factors(r, device)),
                   *_routes(mur, x, k, init, kw, dtype))


def config1_mur_kl(scale, *, newsgroups_root=None, device="cuda", dtype=torch.float32,
                   cap=None, x=None):
    """MUR KL on the tf-idf stand-in, or on 20-newsgroups (run_configs.py:99-133)."""
    device = torch.device(device)
    if newsgroups_root:
        from ..data.loaders import load_newsgroups_tfidf

        csr, _, _ = load_newsgroups_tfidf(newsgroups_root, max_features=20000)
        x, k = _on(np.asarray(csr.todense(), dtype=np.float64), device), 50
    else:
        m, n, k = max(200, int(20000 * scale)), max(100, int(11000 * scale)), 50
        k = min(k, min(m, n) // 2)
        x = (_on(tfidf_like(m, n, n_topics=k, seed=1), device) if x is None
             else _given(x, (m, n), "config1"))
    kw = capped(dict(distance_type="kl", min_iter=20, max_iter=300, tol1=1e-6, tol2=1e-6),
                cap)
    init, init_s = init_f64(x, k)
    out = _header("MUR-KL tfidf", x, k, init_s)
    return _scored(out, "final_kl", lambda r: kl_f64(x, *_factors(r, device)),
                   *_routes(mur, x, k, init, kw, dtype))


def config2_anls_recall(scale, *, movielens_path=None, device="cuda", dtype=torch.float32,
                        cap=None):
    """ANLS with FCNNLS on the MovieLens stand-in, or on MovieLens, and
    recall@10 of ours against the reference's factors (run_configs.py:136-173)."""
    device = torch.device(device)
    if movielens_path:
        from ..data.loaders import load_movielens

        csr, _, _ = load_movielens(movielens_path)
        x, k = _on(np.asarray(csr.todense(), dtype=np.float64), device), 64
    else:
        m, n, k = max(120, int(6040 * scale)), max(80, int(3706 * scale)), 64
        k = min(k, min(m, n) // 2)
        x = _on(movielens_like(m, n, density=0.2, seed=2), device)
    kw = capped(dict(min_iter=5, max_iter=40, tol1=1e-6, tol2=1e-6), cap)
    init, init_s = init_f64(x, k)
    out = _header("ANLS recommender", x, k, init_s)
    fit = functools.partial(anls, use_fcnnls=True)
    ours, ref, plain = _routes(fit, x, k, init, kw, dtype)
    _scored(out, "rel_err", lambda r: rel_err(x, *_factors(r, device)), ours, ref, plain)
    # retrieval: our top-10 against the reference factors' top-10
    (ow, oh), (rw, rh) = _factors(ours[0], device), _factors(ref[0], device)
    _, ours_idx = topk_scores_dense(ow[:64], oh, 10)
    _, ref_idx = topk_scores_dense(rw[:64], rh, 10)
    out["recall10_vs_ref"] = recall_at_k(ours_idx, ref_idx)
    return out


def _trace(res):
    return np.asarray(res.obj_history, dtype=np.float64)


def _max_rel_dev(got, want):
    return float(np.max(np.abs(want - got) / np.maximum(np.abs(want), 1e-12)))


def config3_admm_sparse(scale, *, device="cuda", dtype=torch.float32, x=None):
    """ADMM with L1 on H on the sparse stand-in, fixed and adaptive rho, and
    a 25-iteration trajectory against the reference and against the
    reference on X (1 + 1e-15), the control (run_configs.py:176-226)."""
    device = torch.device(device)
    m, n, k = max(200, int(50000 * scale)), max(100, int(20000 * scale)), 128
    k = min(k, min(m, n) // 2)
    if x is None:
        x = _on(densify(sparse_csr(m, n, density=0.02, k=k, seed=3)), device)
    else:
        x = _given(x, (m, n), "config3")
    kw = dict(distance_type="eu", rho=1.0, reg_w=(0, "nn"), reg_h=(0.1, "l1n"),
              min_iter=10, max_iter=150, tol1=1e-6, tol2=1e-6)
    init, init_s = init_f64(x, k)
    out = _header("ADMM sparse L1(H)", x, k, init_s)

    def err(r):
        return rel_err(x, *_factors(r, device))

    fixed, ref, plain = _routes(admm, x, k, init, kw, dtype)
    damped, damped_s = _route(functools.partial(admm, rho_mode="adaptive"), x, k, init,
                              dtype, kw)
    out["fixed"] = {"i": fixed[0].i, "rel_err": err(fixed[0]), "wall_s": round(fixed[1], 3)}
    out["rho_damped"] = {"i": damped.i, "rel_err": err(damped), "wall_s": round(damped_s, 3)}
    out["ref_i"], out["ref_rel_err"] = ref[0].i, err(ref[0])
    out["ref_wall_s"] = round(ref[1], 3)
    out["final_err_deviation"] = deviation(out["fixed"]["rel_err"], out["ref_rel_err"])
    out["iters_match"] = fixed[0].i == ref[0].i
    plain_err = err(plain[0])
    out["plain_f32"] = {"i": plain[0].i, "rel_err": plain_err,
                        "final_err_deviation": deviation(plain_err, out["ref_rel_err"]),
                        "wall_s": round(plain[1], 3)}
    # ADMM's objective is not monotone and its test stops at the first rise,
    # so the stop is sensitive to rounding: a fixed budget with no early stop
    # (min_iter == max_iter) is the robust comparison
    kw_fixed = dict(kw, max_iter=25, min_iter=25, tol1=1e-9, tol2=1e-9)
    ours_t, ref_t, plain_t = (_trace(r) for r, _ in _routes(admm, x, k, init, kw_fixed, dtype))
    out["trajectory_max_rel_dev"] = _max_rel_dev(ours_t, ref_t)
    out["plain_f32"]["trajectory_max_rel_dev"] = _max_rel_dev(plain_t, ref_t)
    # control: the reference against itself on X (1 + 1e-15); ours means
    # something only where it exceeds this self-divergence
    x_pert = x.double() * (1.0 + 1e-15)
    ref_p, _ = _route(admm, x_pert, k, init, torch.float64, kw_fixed, use_pallas=False)
    del x_pert
    out["ref_self_divergence"] = _max_rel_dev(_trace(ref_p), ref_t)
    return out


def config4_ao_admm_sharded(scale, *, device="cuda", dtype=torch.float32):
    """AO-ADMM KL with L1 on W and Tikhonov on H, on one device and over a
    mesh of the process group's ranks (run_configs.py:229-258): the
    script's (2, 4) over 8 devices, (1, 1) on a world of one, where the
    mesh run must give the one-device bits (``sharded_same_bits``).  Without
    a process group, one of a single rank is brought up and taken down."""
    import torch.distributed as dist

    from ..parallel import ao_admm_mesh, build_mesh

    device = torch.device(device)
    m, n, k = max(128, int(10000 * scale)), max(64, int(5000 * scale)), 32
    k = min(k, min(m, n) // 2)
    # divisible shapes for the (2, 4) mesh
    m -= m % 2
    n -= n % 4
    x = _on(lowrank_dense(m, n, k, seed=4, dtype=np.float64), device)
    kw = dict(distance_type="kl", reg_w=(0.05, "l1n"), reg_h=(0.05, "l2n"),
              min_iter=10, max_iter=60, tol1=1e-6, tol2=1e-6)
    init, init_s = init_f64(x, k)
    out = _header("AO-ADMM-KL mixed-reg", x, k, init_s)
    ours, ref, plain = _routes(ao_admm, x, k, init, kw, dtype)
    _scored(out, "final_kl", lambda r: kl_f64(x, *_factors(r, device)), ours, ref, plain)

    brought_up = not dist.is_initialized()
    try:
        mesh = build_mesh(device_type=device.type)
        world = dist.get_world_size()
        sharded, sharded_s = _route(functools.partial(ao_admm_mesh, mesh=mesh), x, k, init,
                                    dtype, kw)
    finally:
        if brought_up and dist.is_initialized():
            dist.destroy_process_group()
    out["mesh"] = [int(s) for s in mesh.shape]
    out["sharded_i"] = sharded.i
    out["sharded_final_kl"] = kl_f64(x, *_factors(sharded, device))
    out["sharded_wall_s"] = round(sharded_s, 3)
    out["sharded_matches"] = bool(np.isclose(out["sharded_final_kl"], out["final_kl"],
                                             rtol=1e-6))
    single = ours[0]
    out["sharded_same_bits"] = (world == 1 and sharded.i == single.i and all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in ((sharded.w, single.w), (sharded.h, single.h),
                     (sharded.obj_history, single.obj_history))))
    return out


def gate(result):
    """Phase 13's gate on one config's record: (held, tolerance).  Ours
    within GATE of the float64 route's final error (config 3: the fixed-rho
    run; configs 1 and 4: the final KL), or within twice the plain f32
    route's deviation where that itself exceeds GATE."""
    plain = result["plain_f32"]["final_err_deviation"]
    tol = GATE if plain <= GATE else 2.0 * plain
    return result["final_err_deviation"] <= tol, tol


def runners(newsgroups_root=None, movielens_path=None):
    return [config0_mur_eu,
            functools.partial(config1_mur_kl, newsgroups_root=newsgroups_root),
            functools.partial(config2_anls_recall, movielens_path=movielens_path),
            config3_admm_sparse, config4_ao_admm_sharded]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--configs", default="0,1,2,3,4")
    ap.add_argument("--newsgroups-root", default=None,
                    help="path to a 20news-bydate-style directory tree: "
                         "config1 runs on the real archive")
    ap.add_argument("--max-iter-cap", type=int, default=None,
                    help="cap min/max_iter of configs 0-2")
    ap.add_argument("--movielens-path", default=None,
                    help="path to ratings.dat/u.data/ratings.csv: "
                         "config2 runs on the real archive")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the configs run (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("run_configs: needs a CUDA card (or --device cpu)", file=sys.stderr)
        return 2
    wanted = {int(c) for c in args.configs.split(",")}
    report = {"scale": args.scale, "reference": f"float64 plain route on {args.device}",
              "reference_available": True, "max_iter_cap": args.max_iter_cap,
              "device": args.device, "configs": []}
    for idx, fn in enumerate(runners(args.newsgroups_root, args.movielens_path)):
        if idx not in wanted:
            continue
        kw = {"cap": args.max_iter_cap} if idx in (0, 1, 2) else {}
        t0 = time.perf_counter()
        result = fn(args.scale, device=args.device, **kw)
        result["total_wall_s"] = round(time.perf_counter() - t0, 3)
        report["configs"].append(result)
        print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
