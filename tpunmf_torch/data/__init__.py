from .loaders import flatten_stack, load_matrix, load_movielens, load_newsgroups_tfidf
from .sparse_panels import PanelStream, densify
from .synthetic import lowrank_dense, movielens_like, sparse_csr, tfidf_like

__all__ = ["PanelStream", "densify", "flatten_stack", "load_matrix", "load_movielens",
           "load_newsgroups_tfidf", "lowrank_dense", "movielens_like", "sparse_csr",
           "tfidf_like"]
