"""nmfbench: the benchmark of tpunmf_torch on one NVIDIA H100.

``python3 nmfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``: whole fits of
``tpunmf_torch.NMF.factorize`` in a closed loop, then a comparison of a
sample of them with a plain reference.  Configurations, traffic mixes,
methods (work counts and references), generators, limits and per-layer
metrics are files of their own under this directory, found by the names
``BENCHMARK.json`` gives.
"""
