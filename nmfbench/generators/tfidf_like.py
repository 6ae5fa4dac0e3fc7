"""A term-document TF-IDF matrix with topic structure, made on the device.

The recipe of ``tfidf_like`` in tpunmf_torch/data/synthetic.py, rewritten
in torch with a seeded generator on the device (the numpy original loops
over documents on the host): topics are Zipf-weighted term distributions
(a permuted 1/rank times a uniform draw, normalised); each document mixes
1 to 3 distinct topics evenly and draws ``doc_len`` terms from the mix;
then tf = counts / document length and idf = log((1 + docs) / (1 + df)) + 1.
X is (terms, documents) in float32.
"""
from __future__ import annotations

import torch


def make(config: dict, gen: torch.Generator, device) -> dict:
    """{"x": X} for ``config`` (shape m x n, params n_topics, doc_len)."""
    m, n = config["shape"]["m"], config["shape"]["n"]
    topics = config["params"]["n_topics"]
    doc_len = config["params"]["doc_len"]
    f32 = dict(dtype=torch.float32, device=device)
    base = 1.0 / torch.arange(1, m + 1, **f32)
    perm = torch.argsort(torch.rand((topics, m), generator=gen, **f32), dim=1)
    topic_term = base[perm] * torch.rand((topics, m), generator=gen, **f32)
    topic_term /= topic_term.sum(dim=1, keepdim=True)
    # each document: 1-3 distinct topics, mixed evenly
    n_mix = torch.randint(1, 4, (n,), generator=gen, device=device)
    chosen = torch.argsort(torch.rand((n, topics), generator=gen, **f32), dim=1)[:, :3]
    weight = (torch.arange(3, device=device)[None, :] < n_mix[:, None]) / n_mix[:, None]
    mix = torch.zeros((n, topics), **f32).scatter_(1, chosen, weight.to(torch.float32))
    prob = mix @ topic_term                                          # (docs, terms)
    draws = torch.multinomial(prob, doc_len, replacement=True, generator=gen)
    del prob
    counts = torch.zeros((n, m), **f32)
    counts.scatter_add_(1, draws, torch.ones(draws.shape, **f32))
    tf = counts / torch.clamp(counts.sum(dim=1, keepdim=True), min=1.0)
    df = (counts > 0).sum(dim=0).to(torch.float32)
    del counts
    idf = torch.log((1.0 + n) / (1.0 + df)) + 1.0
    return {"x": (tf * idf[None, :]).T.contiguous()}
