"""Command-line interface: ``python -m tpunmf_torch <command>``.

``tpunmf``'s CLI on the port: factorize a data file with any ported
solver, grid-search over parameters, or run the headline benchmark
(``tpunmf_torch.bench``, on the card).  ``--device`` (``cuda``, the
default, or ``cpu``) says where the loaded matrix goes: the port runs on
the card unless asked for the CPU, and never falls back to it; ``bench``
needs an H100 and raises without one.

    python -m tpunmf_torch factorize data.npy -k 10 --distance-type eu
    python -m tpunmf_torch grid data.npy --features 5,10 --lambda-w 0,0.1 --no-save
    python -m tpunmf_torch bench [--deltas ao_admm=200,ao_admm_local_l1inf=100]
"""
from __future__ import annotations

import argparse
import json
import sys


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("data", help="input matrix (.npy/.npz/.mat/.csv)")
    p.add_argument("-k", "--factors", type=int, required=True)
    from .api import _METHODS

    p.add_argument("-m", "--method", default="mur", choices=list(_METHODS))
    p.add_argument("--distance-type", default=None, choices=["eu", "kl"])
    p.add_argument("--ntf-update", default=None, choices=["mur", "hals"],
                   help="CP update family for -m ntf")
    p.add_argument("--beta", type=float, default=None,
                   help="beta-divergence objective for mur (0=IS, 1=KL, 2=EU)")
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--min-iter", type=int, default=None)
    p.add_argument("--tol1", type=float, default=None)
    p.add_argument("--tol2", type=float, default=None)
    p.add_argument("--nndsvd", default=None,
                   help="NNDSVD variant: zero|mean|random (omit for random init)")
    p.add_argument("--key", type=str, default=None,
                   help="dataset key inside .npz/.mat archives")
    p.add_argument("--save-dir", default="./results")
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--param-file", default=None,
                   help="importable module exposing method_params")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path (enables periodic save + resume)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the matrix goes (default: the CUDA card)")


def _solver_params(args) -> dict:
    params = {}
    if args.method == "semi_nmf" and (
            args.distance_type is not None or args.nndsvd is not None):
        # semi-NMF is Euclidean with its own exact-LS W init
        raise SystemExit("--distance-type/--nndsvd do not apply to semi_nmf")
    if args.method == "onmf" and args.distance_type is not None:
        raise SystemExit("--distance-type does not apply to onmf "
                         "(Euclidean by construction)")
    if args.method == "robust" and args.distance_type is not None:
        raise SystemExit("--distance-type does not apply to robust "
                         "(l2,1 norm by construction)")
    if args.method == "ntf":
        if args.nndsvd is not None:
            raise SystemExit("--nndsvd does not apply to ntf (random CP init)")
        if getattr(args, "ntf_update", None):
            params["update"] = args.ntf_update
    for name in ("distance_type", "max_iter", "min_iter", "tol1", "tol2"):
        val = getattr(args, name)
        if val is not None:
            params[name] = val
    if args.nndsvd is not None:
        params["nndsvd_init"] = (True, args.nndsvd)
    if getattr(args, "beta", None) is not None:
        if args.method != "mur":
            raise SystemExit("--beta requires -m mur")
        if args.distance_type is not None:
            raise SystemExit("--beta and --distance-type are mutually "
                             "exclusive (beta IS the objective)")
        params["beta"] = args.beta
    if args.checkpoint:
        params["checkpoint_path"] = args.checkpoint
        params["resume"] = True
    if args.verbose:
        params["verbose"] = True
    return params


def _load(args, flatten=True):
    """The data file as a tensor on ``--device`` (float64 becomes float32
    on the card, as the port's numpy input does)."""
    import torch

    from .core.device import as_input
    from .data import load_matrix

    data = load_matrix(args.data, key=args.key, flatten=flatten)
    if args.device == "cpu":
        return torch.from_numpy(data)
    return as_input(data)


def cmd_factorize(args) -> int:
    from .api import NMF

    params = _solver_params(args)
    model = NMF(_load(args, flatten=(args.method != "ntf")), args.factors,
                param_file=args.param_file)
    results = model.factorize(method=args.method, **params)
    print(json.dumps({
        "method": args.method,
        "iterations": results.i,
        "final_objective": float(results.obj_history[-1]),
    }))
    if not args.no_save:
        model.save_factorization(save_dir=args.save_dir)
    return 0


def cmd_grid(args) -> int:
    from .experiments import grid_search

    if args.checkpoint:
        print("error: --checkpoint is not supported with grid "
              "(combinations would share one state file)", file=sys.stderr)
        return 2
    if args.method in ("ntf", "robust"):
        # neither takes the lambda_w/lambda_h kwargs the grid sweeps
        print(f"error: grid does not support -m {args.method} "
              "(no lambda_w/lambda_h parameters to sweep)", file=sys.stderr)
        return 2
    params = _solver_params(args)
    features = [int(x) for x in args.features.split(",")]
    lws = [float(x) for x in args.lambda_w.split(",")]
    lhs = [float(x) for x in args.lambda_h.split(",")]
    out = grid_search(
        _load(args), method=args.method, features=features, lambda_w=lws,
        lambda_h=lhs, save_dir=None if args.no_save else args.save_dir,
        **params,
    )
    for params, res in out:
        print(json.dumps({**params, "i": res.i,
                          "final_objective": float(res.obj_history[-1])}))
    return 0


def _deltas(text: str) -> dict:
    """RATE_DELTAS with the families that "name=count,..." names replaced;
    each count an integer of at least 1."""
    from .bench import RATE_DELTAS

    out = dict(RATE_DELTAS)
    for item in filter(None, text.split(",")):
        name, _, count = item.partition("=")
        if name not in out:
            raise SystemExit(f"--deltas: no solver family {name!r} (one of {list(out)})")
        if not count.strip().isdigit() or int(count) < 1:
            raise SystemExit(f"--deltas: {item!r} is not name=count with a count of at least 1")
        out[name] = int(count)
    return out


def cmd_bench(args) -> int:
    from .bench import main as bench_main

    bench_main(deltas=_deltas(args.deltas))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tpunmf_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_f = sub.add_parser("factorize", help="factorize a data file")
    _add_common(p_f)
    p_f.set_defaults(fn=cmd_factorize)

    p_g = sub.add_parser("grid", help="grid search (legacy-CLI capability)")
    _add_common(p_g)
    p_g.add_argument("--features", default="10", help="comma-separated ranks")
    p_g.add_argument("--lambda-w", default="0", help="comma-separated values")
    p_g.add_argument("--lambda-h", default="0", help="comma-separated values")
    p_g.set_defaults(fn=cmd_grid)

    p_b = sub.add_parser("bench", help="run the headline benchmark")
    p_b.add_argument("--deltas", default="",
                     help="solver rates' extra iterations as name=count,... "
                          "(default: bench.py's, tpunmf_torch.bench.RATE_DELTAS)")
    p_b.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except NotImplementedError as e:  # what tpunmf refuses too (bf16 X in ANLS, AO-ADMM)
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
