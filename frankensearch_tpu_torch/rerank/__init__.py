"""Neural rerank / quality-tier inference on PyTorch: the BERT encoder
(``bert.py``), the quality-tier embedder (``encoder.py``), the
cross-encoder reranker (``cross_encoder.py``) and the rerank step
(``pipeline.py``). Port of frankensearch_tpu/rerank.
"""
