from .synthetic import lowrank_dense, movielens_like, tfidf_like

__all__ = ["lowrank_dense", "movielens_like", "tfidf_like"]
