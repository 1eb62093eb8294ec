"""The port runs where jax is not installed.

A subprocess makes ``import jax`` fail (``sys.modules["jax"] = None``),
imports ``frankensearch_tpu_torch`` and serves a tiny hybrid
``search_batch`` on the CPU, over the dense lexical lane and then over the
blocked (split, flat, DAAT) layout: nothing on the port's path may reach
jax, directly or through a reference module.
"""

import os
import subprocess
import sys

SCRIPT = r"""
import sys, tempfile
sys.modules["jax"] = None
import numpy as np
import frankensearch_tpu_torch as fst
from frankensearch_tpu.core.types import IndexableDocument

dev = fst.resolve_device("cpu")
docs = [IndexableDocument(doc_id=f"d{i}", content=text) for i, text in enumerate(
    ["rust async futures", "jax tpu compile", "bm25 lexical ranking",
     "vector cosine search", "sqlite write ahead log"])]
emb = fst.HashEmbedder(dim=32)
mem = fst.MemoryLexicalIndex.bulk_build(docs)
with tempfile.TemporaryDirectory() as root:
    index = fst.TwoTierIndex.create(
        root, emb.embed_batch([d.content for d in docs]), [d.doc_id for d in docs],
        emb.identity(), device=dev)
    searcher = fst.TwoTierSearcher(
        index, emb, lexical=fst.DeviceBm25Index(mem, device=dev),
        config=fst.TwoTierConfig(fast_only=True))
    out = searcher.search_batch(["vector search", "write ahead log"], k=3)
assert out[0].results[0].doc_id == "d3", out[0].results
assert out[1].results[0].doc_id == "d4", out[1].results
assert all(o.metrics.phase1_fused for o in out) and searcher.last_fusion_path == "device"

# the blocked scale: split layout, flat lane, DAAT (thresholds lowered)
from frankensearch_tpu_torch.lexical import daat, device_bm25, hot_arm
from frankensearch_tpu_torch.ops import _build, hybrid_phase1
device_bm25.BLOCKED_THRESHOLD_POSTINGS = 1
hot_arm.HOT_MIN_POSTINGS = 1
hot_arm.HOT_MAX_TERMS = 2
lex = fst.BulkDeviceBm25Index(docs, device=dev)
assert lex._hot is not None and lex._term_major() is not None
with tempfile.TemporaryDirectory() as root:
    index = fst.TwoTierIndex.create(
        root, emb.embed_batch([d.content for d in docs]), [d.doc_id for d in docs],
        emb.identity(), device=dev)
    searcher = fst.TwoTierSearcher(
        index, emb, lexical=lex, config=fst.TwoTierConfig(fast_only=True))
    out = searcher.search_batch(["write ahead log", "bm25 ranking"], k=3)
assert out[0].results[0].doc_id == "d4" and out[1].results[0].doc_id == "d2", out
assert searcher.last_phase1_lex_lane in ("blocked", "mixed", "daat")
assert sys.modules["jax"] is None
print("OK")
"""


def test_port_serves_without_jax():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=repo, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")
