"""Work of one iteration by method, one file each: ``per_iteration(m, n, k, ...)``."""
