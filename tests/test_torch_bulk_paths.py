"""The port's vectorized host paths against the JAX reference's per-item
loops, on the same inputs: the HashEmbedder's batch sum, the document
canonicalizer's skips, the memory index's delete (the doc's own terms, or
every term when its text is gone) and ``DeviceBm25Index`` built from a
memory index after deletes. Each is held exactly: vectors bitwise, strings,
postings and scores equal."""

import numpy as np
import pytest
import torch

from frankensearch_tpu.core import canonicalize as r_canon
from frankensearch_tpu.embed.hash_embedder import HashEmbedder as RHash
from frankensearch_tpu.lexical import device_bm25 as jbm
from frankensearch_tpu_torch.core import canonicalize as p_canon
from frankensearch_tpu_torch.embed.hash_embedder import HashEmbedder as PHash
from frankensearch_tpu_torch.lexical import device_bm25 as tbm
from tests import test_torch_hot_arm as th

CPU = torch.device("cpu")
ATOMS = ["w1", "alpha", "Beta", " ", "  ", "\t", "\n", "\n\n\n", "# ", "> ", "---", "* ", "_x_", "**b**",
         "~~s~~", "`c`", "```py\n", "```", "[l](u)", "![i](u)", "!", "[", "-", "\f", "\v", "\r", "é",
         "é", " ", " ", "x" * 45, "42"]


def _texts(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return ["".join(ATOMS[i] for i in rng.integers(0, len(ATOMS), size=int(rng.integers(0, 50))))
            for _ in range(n)]


def _zipf_texts(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    vocab = np.array([f"w{i:04d}" for i in range(2000)])
    return [" ".join(vocab[(rng.zipf(1.3, size=int(rng.integers(0, 70))) - 1) % 2000]) for _ in range(n)]


@pytest.mark.parametrize("mode,dim", [("jl", 256), ("jl", 384), ("bow", 256), ("jl", 64)])
def test_hash_embed_batch_is_the_reference_bitwise(mode, dim):
    texts = _zipf_texts(300, 1) + _texts(100, 2) + ["", "a a a a b", "b a", "A a"]
    ref, port = RHash(dim=dim, mode=mode), PHash(dim=dim, mode=mode)
    want = ref.embed_batch(texts)
    assert port.embed_batch(texts).tobytes() == want.tobytes()
    # a batch of one, and a batch in another order, give each text's row
    assert port.embed_batch(texts[5:6]).tobytes() == want[5:6].tobytes()
    assert port.embed_batch(texts[::-1]).tobytes() == want[::-1].tobytes()
    assert port.embed_batch([]).shape == (0, dim)


def test_canonicalize_document_is_the_reference():
    rc, pc = r_canon.DefaultCanonicalizer(max_chars=300), p_canon.DefaultCanonicalizer(max_chars=300)
    for text in _texts(3000, 3) + _zipf_texts(200, 4) + ["", "ab", "   ", "a  b", "a\tb", "x\n  y\n\n\n\nz"]:
        got, stats = pc.canonicalize_document_with_stats(text)
        want, rstats = rc.canonicalize_document_with_stats(text)
        assert got == want, repr(text)
        assert vars(stats) == vars(rstats)


def _docs(n: int, seed: int):
    from frankensearch_tpu.core.types import IndexableDocument

    texts = _zipf_texts(n, seed)
    return [IndexableDocument(doc_id=f"d{i:04d}", content=t, title=f"title w{i % 7:04d}" if i % 3 == 0 else None)
            for i, t in enumerate(texts)]


def _state(mem):
    postings, stats, docs = mem.snapshot_postings()
    return ({f: {t: list(p.items()) for t, p in terms.items()} for f, terms in postings.items()},
            {f: (s.total_tokens, s.doc_count) for f, s in stats.items()}, sorted(docs))


@pytest.mark.parametrize("texts_kept", [True, False])
def test_memory_delete_is_the_reference(texts_kept):
    """Deletes and re-adds leave the postings, their order and the stats as
    the reference's scan of every term does; an entry without its full text
    takes that scan itself."""
    from frankensearch_tpu.core.types import IndexableDocument

    docs = _docs(400, 5)
    ref, port = th.memory_pair(docs)
    gone = [f"d{i:04d}" for i in range(0, 400, 7)]
    if not texts_kept:
        for d in gone:
            port._docs[d].content_full = ""
    again = [IndexableDocument(doc_id=f"d{i:04d}", content=f"fresh w0001 w{i:04d}") for i in range(1, 400, 11)]
    for mem, convert in ((ref, lambda ds: ds), (port, th.port_docs)):
        for d in gone:
            mem.delete_document(d)
        for d in convert(again):
            mem.add_document(d)
        mem.commit()
    assert _state(port) == _state(ref)


def test_device_bm25_from_memory_after_deletes_is_the_reference():
    docs = _docs(500, 6)
    ref_mem, port_mem = th.memory_pair(docs)
    for mem in (ref_mem, port_mem):
        for i in range(0, 500, 9):
            mem.delete_document(f"d{i:04d}")
        mem.commit()
    ref, port = jbm.DeviceBm25Index(ref_mem), tbm.DeviceBm25Index(port_mem, device=CPU)
    queries = ["w0001 w0002", "w0000", "w0100 w0003 title", "w0006 w1999", "nothing"]
    got = [[(c.doc_id, c.score) for c in r] for r in port.search_candidates_batch(queries, 25)]
    want = [[(c.doc_id, c.score) for c in r] for r in ref.search_candidates_batch(queries, 25)]
    assert got == want
    assert port.doc_ids == ref.doc_ids and port.vocab_size == ref.vocab_size
    for fname, arm in ref._arms.items():
        np.testing.assert_array_equal(port._arms[fname].idf_host, np.asarray(arm.idf_host))
