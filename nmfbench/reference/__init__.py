"""Plain references by method, one file each: ``run(x, w0, h0, *, iterations,
params, mask, prec)``.  They import nothing of tpunmf_torch, tpunmf or jax."""
