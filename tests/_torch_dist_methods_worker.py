"""One rank of tests/test_torch_parallel_methods.py's 4-process gloo world.

    python tests/_torch_dist_methods_worker.py RANK WORLD PORT DIR

Brings up the process group with ``tpunmf_torch.parallel``'s
``initialize_multihost`` over localhost:PORT, runs every case of
``CASES`` and ``NTF_MESH_CASES`` through ``NMF(x, k, mesh=...).factorize``
on CPU meshes (2, 2) and (4,) 'cols', ``ntf_sharded`` on a (4,) 'rows' mesh
and the lambda grid on a (4,) 'grid' mesh, all at float64 on
DIR/inputs.npz, then HALS's checkpoints over the (2, 2) mesh through both
backends (``CHECKPOINT``: uninterrupted, interrupted and resumed, resumed
on the (4,) mesh), and writes this rank's results, collective calls and
AO-ADMM's inner trips to DIR/rank{RANK}.npz; the checkpoints stay in DIR.
It imports torch and ``tpunmf_torch`` only; the parent holds the results
against ``tpunmf`` on JAX.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tpunmf_torch  # noqa: E402
from tpunmf_torch import experiments  # noqa: E402
from tpunmf_torch import parallel as par  # noqa: E402
from tpunmf_torch.solvers.ao_admm import trips  # noqa: E402
from tpunmf_torch.solvers.onmf import orthogonality_residual  # noqa: E402

MESHES = (("m22", (2, 2), ("rows", "cols")), ("m4", (4,), ("cols",)),
          ("r4", (4,), ("rows",)), ("g4", (4,), ("grid",)))
# (name, method, options): every case from the same given inits; "nndsvd"
# cases from NNDSVD 'zero' instead
CASES = (
    ("hals", "hals", dict(inner_sweeps=2)),
    ("hals_gram_nndsvd", "hals", dict(objective="gram", nndsvd=True)),
    ("anls", "anls", dict()),
    ("anls_bpp", "anls", dict(nnls_solver="bpp")),
    ("admm_eu", "admm", dict(reg_h=(0.1, "l1n"))),
    ("admm_kl", "admm", dict(distance_type="kl")),
    ("admm_eu_adaptive", "admm", dict(rho_mode="adaptive", reg_h=(0.05, "l1inf"))),
    ("admm_kl_adaptive", "admm", dict(distance_type="kl", rho_mode="adaptive")),
    ("ao_admm_eu", "ao_admm", dict()),
    ("ao_admm_kl", "ao_admm", dict(distance_type="kl", reg_w=(0.05, "l1n"),
                                   reg_h=(0.05, "l2n"))),
    ("ao_admm_local", "ao_admm", dict(rho_mode="adaptive", reg_w=(0.1, "l1inf"),
                                      upper_bound=64.0)),
    ("ao_admm_l1inf_h", "ao_admm", dict(reg_h=(0.1, "l1inf"))),
    ("masked_eu", "mur", dict(distance_type="eu", mask=True, tol2=0.1)),
    ("masked_kl", "mur", dict(distance_type="kl", mask=True, tol2=0.1)),
    # mixed-sign X; W by least squares against the given H, on rank 0
    ("semi", "semi_nmf", dict(data="xs", h_only=True)),
    ("onmf_h", "onmf", dict()),
    ("onmf_w", "onmf", dict(orthogonal="w")),
    ("robust", "robust", dict()),
    ("beta0", "mur", dict(beta=0.0)),
    ("beta05", "mur", dict(beta=0.5)),
    ("beta1", "mur", dict(beta=1.0)),
    ("beta2", "mur", dict(beta=2.0)),
    ("mur_gram", "mur", dict(distance_type="eu", objective="gram")),
    ("mur_lagged", "mur", dict(distance_type="kl", objective="lagged")),
    ("mur_every", "mur", dict(distance_type="kl", objective_every=3)),
    # every level a fixed number of iterations (tol 0), from NNDSVD 'zero'
    ("ml_mur", "mur", dict(multilevel=dict(levels=2, factor=2, coarse_iters=6),
                           distance_type="eu", nndsvd=True, tol2=0.0, max_iter=8)),
    ("ml_hals", "hals", dict(multilevel=dict(levels=2, factor=2, coarse_iters=6),
                             nndsvd=True, tol2=0.0, max_iter=8)),
)
# absolute tolerances at which every family stops early here
STOP = dict(min_iter=3, max_iter=40, tol1=0.0, tol2=3e-3)
NTF_CASES = (("eu", "mur"), ("eu", "hals"), ("kl", "mur"))
# the facade's ntf over the meshes (normalize=True, the default): (name,
# options); modes 0 and 1 of X (8, 12, 5) split as tpunmf's facade splits
# them
NTF_MESH_CASES = (("eu_mur", dict(distance_type="eu", update="mur")),
                  ("eu_hals", dict(distance_type="eu", update="hals")),
                  ("kl", dict(distance_type="kl")),
                  ("masked", dict(distance_type="eu", mask=True)))
NTF_STOP = dict(min_iter=3, max_iter=12, tol1=0.0, tol2=1e-3)
# HALS's checkpoints over the (2, 2) mesh: blocks of 5 of 10 iterations
CHECKPOINT = dict(method="hals", min_iter=10, max_iter=10, tol1=0.0, tol2=0.0,
                  checkpoint_every=5)


class Interrupt(Exception):
    pass


def stop_after_one_block(carry):
    raise Interrupt


def ntf_kwargs(options, inp):
    """The factorize() keywords of an ntf case (shared with the parent)."""
    kw = {**NTF_STOP, **options, "factors_init": [inp[f"n{m}"] for m in range(3)]}
    if kw.pop("mask", False):
        kw["mask"] = inp["mask3"]
    return kw


def case_kwargs(options, inp):
    """The factorize() keywords of a case (shared with the parent)."""
    kw = dict(options)
    kw.pop("data", None)
    if kw.pop("nndsvd", False):
        kw["nndsvd_init"] = (True, "zero")
    elif kw.pop("h_only", False):
        kw["h_init"] = inp["h0"]
    else:
        kw.update(w_init=inp["w0"], h_init=inp["h0"])
    if kw.pop("mask", False):
        kw["mask"] = inp["mask"]
    return {**STOP, **kw}


def case_data(options, kw, inp):
    """The X a case factorizes: its own, else the KL X for KL, else x."""
    if "data" in options:
        return inp[options["data"]]
    return inp["xkl"] if kw.get("distance_type") == "kl" else inp["x"]


def main():
    rank, world, port, d = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    par.initialize_multihost(f"localhost:{port}", world, rank, backend="gloo")
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    out = {}
    meshes = {name: par.build_mesh(shape, names, device_type="cpu")
              for name, shape, names in MESHES}

    def put(key, value):
        out[key] = value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)

    def calls():
        return np.array([par.calls[k] for k in sorted(par.calls)])

    x = torch.from_numpy(inp["x"])
    for name in ("m22", "m4"):
        for case, method, options in CASES:
            kw = case_kwargs(options, inp)
            data = torch.from_numpy(case_data(options, kw, inp))
            par.reset_calls()
            trips.reset()
            res = tpunmf_torch.NMF(data, 4, mesh=meshes[name]).factorize(method=method, **kw)
            key = f"{case}/{name}"
            put(key + "/w", res.w)
            put(key + "/h", res.h)
            put(key + "/i", res.i)
            put(key + "/obj", np.asarray(res.obj_history))
            put(key + "/calls", calls())
            put(key + "/trips", np.array([trips.h_calls, trips.h, trips.w_calls, trips.w]))
            if case == "onmf_h":  # the residual of this rank's columns of H
                h_cols = par.local_block(meshes[name], torch.from_numpy(res.h), (None, "cols"))
                put(key + "/orth", orthogonality_residual(h_cols, par.MeshSums(meshes[name])))

    # --- the facade's ntf over the meshes
    for name in ("m22", "m4"):
        for case, options in NTF_MESH_CASES:
            par.reset_calls()
            res = tpunmf_torch.NMF(torch.from_numpy(inp["x3m"]), 3, mesh=meshes[name]).factorize(
                method="ntf", **ntf_kwargs(options, inp))
            key = f"ntf_mesh/{case}/{name}"
            for m, f in enumerate(res.factors):
                put(f"{key}/f{m}", f)
            put(key + "/obj", np.asarray(res.obj_history))
            put(key + "/i", res.i)
            put(key + "/calls", calls())

    # --- a multilevel level that does not divide the (4,) mesh's axis
    try:
        tpunmf_torch.NMF(torch.from_numpy(inp["x40"]), 4, mesh=meshes["m4"]).factorize(
            method="hals", multilevel=dict(levels=2, factor=4), max_iter=2)
        put("ml_uneven", "")
    except ValueError as e:
        put("ml_uneven", str(e))

    # --- HALS's checkpoints over (2, 2): uninterrupted, interrupted and
    # resumed on the same mesh, and resumed on the (4,) mesh
    xt = torch.from_numpy(inp["x"])
    ck = dict(CHECKPOINT, w_init=inp["w0"], h_init=inp["h0"])
    method = ck.pop("method")
    for backend in ("npz", "dcp"):
        base = os.path.join(d, f"ck_{backend}")
        run = dict(ck, checkpoint_backend=backend)
        par.reset_calls()
        full = tpunmf_torch.NMF(xt, 4, mesh=meshes["m22"]).factorize(
            method=method, checkpoint_path=base + "_full", **run)
        put(f"ck/{backend}/full/calls", calls())
        for tag, mesh in (("resumed", "m22"), ("moved", "m4")):
            path = f"{base}_{tag}"
            try:
                tpunmf_torch.NMF(xt, 4, mesh=meshes["m22"]).factorize(
                    method=method, checkpoint_path=path, on_block_end=stop_after_one_block,
                    **run)
            except Interrupt:
                pass
            res = tpunmf_torch.NMF(xt, 4, mesh=meshes[mesh]).factorize(
                method=method, checkpoint_path=path, resume=True, **run)
            for f in ("w", "h", "obj_history"):
                put(f"ck/{backend}/{tag}/{f}", np.asarray(getattr(res, f)))
        for f in ("w", "h", "obj_history"):
            put(f"ck/{backend}/full/{f}", np.asarray(getattr(full, f)))

    # --- ntf_sharded on mode-0 slabs, and its refusals
    mesh = meshes["r4"]
    for dist_type, update in NTF_CASES:
        par.reset_calls()
        res = par.ntf_sharded(mesh, torch.from_numpy(inp["x3"]), 3, distance_type=dist_type,
                              update=update, min_iter=12, max_iter=12, tol1=0, tol2=0,
                              factors_init=[inp[f"f{m}"] for m in range(3)])
        key = f"ntf/{dist_type}/{update}"
        for m, f in enumerate(res.factors):
            put(f"{key}/f{m}", f)
        put(key + "/obj", np.asarray(res.obj_history))
        put(key + "/i", res.i)
        put(key + "/calls", calls())
    bad = [inp[f"g{m}"] for m in range(3)]
    bad[1] = bad[1][:, :1]
    for tag, args, kw in (("divide", (inp["x15"], 2), {}),
                          ("kl_hals", (inp["x16"], 2), dict(distance_type="kl", update="hals")),
                          ("negative", (-inp["x16"], 2), {}),
                          ("factors", (inp["x16"], 2), dict(factors_init=bad))):
        try:
            par.ntf_sharded(mesh, torch.from_numpy(np.ascontiguousarray(args[0])), args[1],
                            **kw)
            put(f"ntf_error/{tag}", "")
        except ValueError as e:
            put(f"ntf_error/{tag}", str(e))

    # --- the lambda grid over 'grid'
    grid = dict(lambda_w=(0.0, 0.1), lambda_h=(0.0, 0.05), n_iter=12, w_init=inp["w0"],
                h_init=inp["h0"], mesh=meshes["g4"], grid_axis="grid")
    for dist_type in ("eu", "kl"):
        data = x if dist_type == "eu" else torch.from_numpy(inp["xkl"])
        par.reset_calls()
        combos, ws, hs, objs = experiments.mur_lambda_grid(data, 4, distance_type=dist_type,
                                                           **grid)
        put(f"grid/{dist_type}/combos", np.array(combos))
        put(f"grid/{dist_type}/ws", ws)
        put(f"grid/{dist_type}/hs", hs)
        put(f"grid/{dist_type}/objs", objs)
        put(f"grid/{dist_type}/calls", calls())
    try:
        experiments.mur_lambda_grid(x, 4, lambda_w=(0.0, 0.1, 0.2), n_iter=2,
                                    mesh=meshes["g4"], grid_axis="grid")
        put("grid/indivisible", "")
    except ValueError as e:
        put("grid/indivisible", str(e))
    put("calls/kinds", np.array(sorted(par.calls)))

    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    print("WORKER_OK", rank, flush=True)


if __name__ == "__main__":
    main()
