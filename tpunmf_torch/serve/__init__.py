from .topk import recall_at_k, topk_retrieval, topk_scores_dense, topk_streaming

__all__ = ["recall_at_k", "topk_retrieval", "topk_scores_dense", "topk_streaming"]
