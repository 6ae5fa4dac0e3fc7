from .synthetic import densify, lowrank_dense, movielens_like, sparse_csr, tfidf_like

__all__ = ["densify", "lowrank_dense", "movielens_like", "sparse_csr", "tfidf_like"]
