"""One rank of tests/test_torch_parallel.py's 4-process gloo world.

    python tests/_torch_dist_worker.py RANK WORLD PORT DIR

Brings up the process group with ``tpunmf_torch.parallel``'s
``initialize_multihost`` over localhost:PORT, builds the test's CPU
meshes, runs every case on DIR/inputs.npz at float64 and writes this
rank's blocks and scalars to DIR/rank{RANK}.npz.  It imports torch and
``tpunmf_torch`` only; the parent holds the blocks against ``tpunmf`` on
JAX.
"""
import os
import sys

import numpy as np
import scipy.sparse as sp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tpunmf_torch  # noqa: E402
from tpunmf_torch import parallel as par  # noqa: E402
from tpunmf_torch.parallel import collectives as coll  # noqa: E402
from tpunmf_torch.serve import topk  # noqa: E402
from tpunmf_torch.solvers import mur_streaming_sharded  # noqa: E402

# (name, shape, axis names): built in this order on every rank
MESHES = (("m22", (2, 2), ("rows", "cols")), ("m4", (4,), ("cols",)),
          ("r4", (4,), ("rank",)), ("r22", (2, 2), ("rows", "rank")))


def main():
    rank, world, port, d = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    par.initialize_multihost(f"localhost:{port}", world, rank, backend="gloo")
    par.initialize_multihost(f"localhost:{port}", world, rank)  # a second call is a no-op
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    out = {}
    meshes = {name: par.build_mesh(shape, names, device_type="cpu")
              for name, shape, names in MESHES}
    for name, mesh in meshes.items():
        for axis in mesh.mesh_dim_names:
            out[f"coords/{name}/{axis}"] = np.array(par.axis_index(mesh, axis))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def put(key, value):
        out[key] = value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)

    x, w0, h0 = inp["x"], inp["w0"], inp["h0"]
    block = par.local_block

    # --- the collectives and shard_problem on the canonical layouts
    for name in ("m22", "m4"):
        mesh = meshes[name]
        sh = par.nmf_shardings(mesh)
        xl, wl, hl = par.shard_problem(mesh, x, w0, h0)
        put(f"shard/{name}/x", xl)
        put(f"shard/{name}/w", wl)
        put(f"shard/{name}/h", hl)
        put(f"coll/{name}/gram_h", par.gram_h(mesh, hl))
        put(f"coll/{name}/gram_w", par.gram_w(mesh, wl))
        put(f"coll/{name}/xht_psum", par.xht_psum(mesh, xl, hl))
        put(f"coll/{name}/wtx_psum", par.wtx_psum(mesh, wl, xl))
        put(f"coll/{name}/ring_xht", par.ring_xht(mesh, xl, hl))
        x_rows = t(block(mesh, x, ("cols", None)))
        h_cols = t(block(mesh, h0, (None, "cols")))
        flipped = par.reshard_rows_to_cols(mesh, x_rows)
        put(f"coll/{name}/rows_to_cols", flipped)
        put(f"coll/{name}/cols_to_rows", par.reshard_cols_to_rows(mesh, flipped))
        put(f"coll/{name}/ring_xht_rotate_h", par.ring_xht_rotate_h(mesh, x_rows, h_cols))
        assert sh["v"] == (("rows", "cols") if name == "m22" else (None, "cols"))
    for name in ("r4", "r22"):
        mesh = meshes[name]
        sh = par.rank_shardings(mesh)
        hl = t(block(mesh, h0, sh["h"]))
        wl = t(block(mesh, w0, (None, "rank")))
        put(f"coll/{name}/wh_psum_rank", par.wh_psum_rank(mesh, wl, hl))
        put(f"coll/{name}/gram_h_rank", par.gram_h_rank(mesh, hl))

    # --- the schedules at the collectives level, 10 iterations
    for dist_type, xs in (("eu", x), ("kl", inp["xkl"])):
        for name in ("m22", "m4"):
            mesh = meshes[name]
            axis = mesh.mesh_dim_names[0]
            w, h, obj = par.mur_ulysses(mesh, t(block(mesh, xs, (axis, None))),
                                        t(block(mesh, w0, (axis, None))), t(h0), n_iter=10,
                                        distance_type=dist_type)
            put(f"ulysses/{dist_type}/{name}/w", w)
            put(f"ulysses/{dist_type}/{name}/h", h)
            put(f"ulysses/{dist_type}/{name}/obj", obj)
        for name in ("r4", "r22"):
            mesh = meshes[name]
            w, h, obj = par.mur_rank_sharded(mesh, t(xs), t(block(mesh, w0, (None, "rank"))),
                                             t(block(mesh, h0, ("rank", None))), n_iter=10,
                                             distance_type=dist_type, lambda_w=0.1,
                                             lambda_h=0.05)
            put(f"rank/{dist_type}/{name}/w", w)
            put(f"rank/{dist_type}/{name}/h", h)
            put(f"rank/{dist_type}/{name}/obj", obj)

    # --- the drivers: global data in, Results out, with an early stop
    stop = dict(min_iter=5, max_iter=300, tol1=0.0, tol2=float(inp["tol2"]))
    for schedule in ("ulysses", "rank"):
        for name in ("m22", "m4"):
            for dist_type in ("eu", "kl"):
                xs = x if dist_type == "eu" else inp["xkl"]
                res = par.mur_sharded(xs, 4, meshes[name], schedule=schedule,
                                      distance_type=dist_type, w_init=w0, h_init=h0,
                                      lambda_w=0.1, **stop)
                key = f"sharded/{schedule}/{name}/{dist_type}"
                put(key + "/w", res.w)
                put(key + "/h", res.h)
                put(key + "/i", res.i)
                put(key + "/obj", np.asarray(res.obj_history))
    res = par.mur_sharded(t(x), 4, meshes["m22"], schedule="ulysses", distance_type="eu",
                          nndsvd_init=(True, "zero"), min_iter=3, max_iter=3)
    put("sharded/nndsvd/w", res.w)
    put("sharded/nndsvd/obj", np.asarray(res.obj_history))

    # --- the facade's mesh= (tpunmf's GSPMD path) and schedule=
    for name in ("m22", "m4"):
        for dist_type in ("eu", "kl"):
            xs = x if dist_type == "eu" else inp["xkl"]
            model = tpunmf_torch.NMF(t(xs), 4, mesh=meshes[name])
            res = model.factorize(method="mur", distance_type=dist_type, w_init=w0,
                                  h_init=h0, lambda_h=0.1, **stop)
            key = f"facade/{name}/{dist_type}"
            put(key + "/w", res.w)
            put(key + "/h", res.h)
            put(key + "/i", res.i)
            put(key + "/obj", np.asarray(res.obj_history))
    res = tpunmf_torch.NMF(t(x), 4).factorize(method="mur", schedule="rank",
                                              mesh=meshes["r4"], distance_type="eu",
                                              w_init=w0, h_init=h0, **stop)
    put("facade/schedule/obj", np.asarray(res.obj_history))

    # --- out-of-core MUR over 'cols'
    csr = sp.csr_matrix((inp["csr_data"], inp["csr_indices"], inp["csr_indptr"]),
                        shape=tuple(inp["csr_shape"]))
    for name in ("m22", "m4"):
        for dist_type, objective in (("eu", "exact"), ("kl", "exact"), ("kl", "lagged")):
            res = mur_streaming_sharded(csr, 3, meshes[name], distance_type=dist_type,
                                        objective=objective, w_init=inp["sw0"],
                                        h_init=inp["sh0"], dtype=torch.float64,
                                        row_block=16, min_iter=2, max_iter=6, tol1=0.0,
                                        tol2=0.0, lambda_w=0.05)
            key = f"streaming/{name}/{dist_type}/{objective}"
            put(key + "/w", res.w)
            put(key + "/h", res.h)
            put(key + "/obj", np.asarray(res.obj_history))

    # --- sharded serving
    wb, hs, excl = inp["wb"], inp["hs"], inp["excl"]
    for name in ("m22", "m4"):
        mesh = meshes[name]
        for mode, kw in (("exact", {}), ("exclude", {"exclude": excl}),
                         ("quantized", {"first_stage_dtype": "bf16"}),
                         ("stored", {"first_stage_dtype": "bf16",
                                     "h_quantized": t(hs).to(torch.bfloat16)})):
            vals, idx = topk.topk_retrieval(mesh, t(wb), t(hs), 7, **kw)
            put(f"topk/{name}/{mode}/vals", vals)
            put(f"topk/{name}/{mode}/idx", idx)
        for mode, kw in (("plain", {}), ("exclude", {"exclude": inp["excl_s"]})):
            vals, idx = topk.topk_streaming(t(wb), inp["hstream"], inp["hstream"].shape[1], 7,
                                            panel_cols=64, mesh=mesh, **kw)
            put(f"topk_streaming/{name}/{mode}/vals", vals)
            put(f"topk_streaming/{name}/{mode}/idx", idx)
        try:
            topk.topk_retrieval(mesh, t(wb), t(hs[:, :-1]), 7)
        except ValueError as e:
            put(f"topk/{name}/indivisible", str(e))

    # --- host ingestion (the parent sets LOCAL_WORLD_SIZE=2: two hosts of two)
    n = x.shape[1]
    for name in ("m22", "m4"):
        mesh = meshes[name]
        start, stop_ = par.host_local_column_range(mesh, n)
        put(f"host/{name}/range", np.array([start, stop_]))
        put(f"host/{name}/block", par.assemble_global_columns(mesh, x[:, start:stop_], n))

    # --- consistency: equal values pass, one rank's other value raises
    par.assert_collective_consistency(1.5)
    try:
        par.assert_collective_consistency(1.5 + (rank == 3))
        put("consistency/raised", "")
    except AssertionError as e:
        put("consistency/raised", str(e))

    # --- what one Ulysses iteration sends
    for name in ("m22", "m4"):
        mesh = meshes[name]
        axis = mesh.mesh_dim_names[0]
        coll.reset_calls()
        par.mur_ulysses(mesh, t(block(mesh, x, (axis, None))), t(block(mesh, w0, (axis, None))),
                        t(h0), n_iter=1)
        put(f"calls/ulysses/{name}", np.array([coll.calls[k] for k in sorted(coll.calls)]))
        coll.reset_calls()
        par.mur_mesh(x, 4, mesh, distance_type="eu", w_init=w0, h_init=h0, min_iter=1,
                     max_iter=1)
        put(f"calls/mesh/{name}", np.array([coll.calls[k] for k in sorted(coll.calls)]))
    put("calls/kinds", np.array(sorted(coll.calls)))

    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    print("WORKER_OK", rank, flush=True)


if __name__ == "__main__":
    main()
