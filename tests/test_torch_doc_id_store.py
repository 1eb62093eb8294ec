"""The packed doc-id store (``index/doc_id_store.py``) behind
``DeviceVectorIndex.doc_ids``, on the CPU.

The store is checked against a plain ``list`` of the same ids: every read
(length, int and slice indexing, iteration, ``take``), equality both ways,
concatenation, and the lazy id -> row map against ``list.index`` through
an index's appends and tombstones. A structural check walks what the
collector would walk from a 100,000-row index and finds no container with
one entry a row. ``hydrate`` is held to the list-backed lookup it replaced,
and unicode ids make an FTVI save / open round trip through ``TwoTierIndex``.
Every search filter's mask over a store is bit-equal to its mask over the
list, and the filters that judge no id read none. A built map rides along
an append and is built once under threads; an FTVI file's packed table is
checked on open.
"""

import gc
import math
import threading
import types

import numpy as np
import pytest
import torch

from frankensearch_tpu_torch.core.errors import IndexCorrupted
from frankensearch_tpu_torch.core.filter import (
    BitsetFilter,
    DateRangeFilter,
    DocTypeFilter,
    FilterChain,
    PredicateFilter,
)
from frankensearch_tpu_torch.core.types import VectorHit
from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex
from frankensearch_tpu_torch.index.doc_id_store import DocIdStore
from frankensearch_tpu_torch.index.fsvi import EmbeddingIdentity, FtviFile, FtviHeader, write_ftvi
from frankensearch_tpu_torch.index.two_tier import TwoTierIndex
from frankensearch_tpu_torch.ops.topk_scan import TopKResult
from frankensearch_tpu_torch.parallel.mesh import make_mesh
from frankensearch_tpu_torch.parallel.sharded_index import ShardedDeviceVectorIndex

CPU = torch.device("cpu")
DIM = 16
IDS = {
    "ascii": [f"d{i:07d}" for i in range(300)],
    "multibyte": ["doc-é", "文档", "🙂🙂", "naïve café", "Ωμέγα", "ß", "\u0000nul", "z"] * 7,
    "empty-ids": ["", "a", "", "", "bc", ""],
    "mixed-lengths": ["x" * (i * 37 % 101) + str(i) for i in range(150)],
    "lone-surrogate": ["a\ud800b", "plain", "\udfff"],
    "one": ["only"],
    "none": [],
}


def ident(dim: int = DIM) -> EmbeddingIdentity:
    return EmbeddingIdentity(embedder_id="store-test", embedder_revision="r1", dim=dim)


def unit_rows(n: int, seed: int = 0, dim: int = DIM) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("case", list(IDS))
def test_store_round_trips_a_list(case):
    ids = IDS[case]
    store = DocIdStore.of(ids)
    n = len(ids)
    assert len(store) == n and DocIdStore.of(store) is store
    assert list(store) == ids and store == ids and ids == store and not store != ids
    assert [store[i] for i in range(n)] == ids
    assert [store[np.int64(i)] for i in range(n)] == ids
    assert [store[-i] for i in range(1, n + 1)] == [ids[-i] for i in range(1, n + 1)]
    for sl in (slice(None), slice(1, None), slice(None, -1), slice(2, 9, 3), slice(None, None, -2), slice(n, n + 5)):
        assert store[sl] == ids[sl]
    for bad in (n, -n - 1):
        with pytest.raises(IndexError):
            store[bad]
    # take over a (B, k) array whose -1 padding the caller drops
    rng = np.random.default_rng(len(ids))
    grid = rng.integers(-1, max(n, 1), size=(5, 7)) if n else np.full((5, 7), -1)
    kept = grid[grid >= 0]
    assert store.take(kept) == [ids[r] for r in kept.tolist()]
    assert store.take(np.zeros((3, 0), dtype=np.int64)) == []
    if n:
        assert store.take(kept.reshape(-1, 1).astype(np.int32)) == [ids[r] for r in kept.tolist()]
        with pytest.raises(IndexError):
            store.take(np.array([[0, -1]]))
    # equality: equal ids, other ids, other kinds
    assert store == DocIdStore.of(list(ids)) and DocIdStore.of(list(ids)) == ids
    assert store != ids + ["extra"] and store != DocIdStore.of(ids + ["extra"])
    if n:
        assert store != ids[::-1] or ids == ids[::-1]
        assert store != tuple(ids)
    # concatenation keeps the old rows and adds the new
    tail = ["new-1", "", "новый"]
    for grown in (store + tail, store + DocIdStore.of(tail), store + []):
        want = ids + (tail if len(grown) > n else [])
        assert grown == want and list(grown) == want and len(grown) == len(want)
    assert store == ids  # the old store is unchanged


@pytest.mark.parametrize("kind", ["single", "sharded"])
@pytest.mark.parametrize("step", ["built", "fresh-append", "superseding-append", "tombstones", "append-then-tombstone"])
def test_row_for_matches_list_index(kind, step):
    ids = [f"doc-{i}-ü" for i in range(40)]
    vecs = unit_rows(40)
    if kind == "single":
        idx = DeviceVectorIndex(vecs, ids, ident(), device=CPU)
    else:
        idx = ShardedDeviceVectorIndex(vecs, ids, ident(), mesh=make_mesh(2, device="cpu"))
    assert idx.doc_ids._row_of is None  # nothing built until a lookup asks
    if step in ("fresh-append", "append-then-tombstone"):
        idx = idx.with_appended(["new-a", "new-b"], unit_rows(2, seed=1))
    elif step == "superseding-append":
        idx = idx.with_appended(["doc-3-ü", "new-a", "doc-39-ü"], unit_rows(3, seed=2))
    if step in ("tombstones", "append-then-tombstone"):
        idx = idx.with_tombstones(["doc-5-ü", "new-a", "never-indexed"])
    as_list = list(idx.doc_ids)
    assert len(as_list) == idx.n_rows == len(set(as_list))
    for doc_id in as_list:
        assert idx.row_for(doc_id) == as_list.index(doc_id)
        assert doc_id in idx.doc_ids
    for missing in ("never-indexed", "doc-3", ""):
        assert idx.row_for(missing) is None and missing not in idx.doc_ids
    if step == "superseding-append":
        assert as_list == ids + ["new-a"]
        np.testing.assert_allclose(idx.vector_for_row(3), unit_rows(3, seed=2)[0], atol=1e-6)
    if "tombstone" in step:
        want = {"doc-5-ü"} | ({"new-a"} if step == "append-then-tombstone" else set())
        assert idx.tombstoned_ids() == want
        assert not idx._valid_host[idx.row_for("doc-5-ü")]


def _largest_tracked_fanout(root) -> tuple[int, str]:
    """The most referents any collector-tracked object reachable from
    ``root`` holds (types, modules and functions are not followed)."""
    seen, todo, worst = {id(root)}, [root], (0, "")
    while todo:
        obj = todo.pop()
        refs = gc.get_referents(obj)
        worst = max(worst, (len(refs), type(obj).__name__))
        for ref in refs:
            if id(ref) in seen or not gc.is_tracked(ref):
                continue
            if isinstance(ref, (type, types.ModuleType, types.FunctionType)):
                continue
            seen.add(id(ref))
            todo.append(ref)
    return worst


HANDFUL = 64


@pytest.mark.parametrize("shape", ["built", "looked-up", "appended", "tombstoned", "list-control"])
def test_index_holds_no_per_row_container(shape):
    n = 100_000
    ids = [f"d{i:07d}" for i in range(n)]
    idx = DeviceVectorIndex(unit_rows(n, dim=8), ids, ident(8), device=CPU)
    del ids
    if shape == "looked-up":
        assert idx.row_for("d0000007") == 7
    elif shape == "appended":
        idx = idx.with_appended(["d0000003", "fresh"], unit_rows(2, seed=3, dim=8))
    elif shape == "tombstoned":
        idx = idx.with_tombstones(["d0000001", "d0099999"])
        assert len(idx.tombstoned_ids()) == 2 and idx.row_for("d0099999") == n - 1
    store = idx.doc_ids
    assert not gc.is_tracked(store._blob) and not gc.is_tracked(store._offsets)
    assert store._row_of is None or not gc.is_tracked(store._row_of)
    fanout, holder = _largest_tracked_fanout(idx)
    if shape == "list-control":
        # the walk finds a list of the ids where one is held
        idx._ids_as_list = list(store)
        assert _largest_tracked_fanout(idx)[0] >= n
    else:
        assert fanout <= HANDFUL, (fanout, holder)


def _list_hydrate(ids: list, result: TopKResult) -> list[list[VectorHit]]:
    """The list-backed lookup ``hydrate`` replaced."""
    return [
        [VectorHit(doc_id=ids[i], score=s, row=i) for s, i in zip(srow, irow) if i >= 0 and math.isfinite(s)]
        for srow, irow in zip(torch.as_tensor(result.scores).tolist(), torch.as_tensor(result.indices).tolist())
    ]


def _assert_same_hits(got, want):
    assert got == want
    for grow, wrow in zip(got, want):
        for g, w in zip(grow, wrow):
            assert type(g.doc_id) is str and type(g.score) is float and type(g.row) is int
            assert (g.doc_id, g.score, g.row) == (w.doc_id, w.score, w.row)


@pytest.fixture(scope="module")
def tombstoned_index():
    ids = ["α-0", "", "doc-2", "🙂", "doc-4"] + [f"row-{i}" for i in range(5, 30)]
    idx = DeviceVectorIndex(unit_rows(30, seed=4), ids, ident(), device=CPU)
    return idx.with_tombstones(["doc-2", "row-7", "row-29"]), ids


@pytest.mark.parametrize("case", ["padded-nonfinite-int32", "int64-rows", "empty-batch", "zero-k", "all-padding"])
def test_hydrate_matches_list_lookup_on_built_results(tombstoned_index, case):
    idx, ids = tombstoned_index
    inf, nan = float("inf"), float("nan")
    scores = [[0.9, 0.5, nan, 0.2, -inf, 0.1], [inf, 0.7, 0.6, -0.3, 0.0, -inf], [0.3, 0.2, 0.1, -inf, -inf, -inf]]
    rows = [[4, 0, 12, 1, -1, 3], [5, 28, 6, 17, 3, 8], [1, 3, 0, -1, -1, -1]]
    s = torch.tensor(scores, dtype=torch.float32)
    r = torch.tensor(rows, dtype=torch.int32)
    if case == "int64-rows":
        r = r.to(torch.int64)
    elif case == "empty-batch":
        s, r = s[:0], r[:0]
    elif case == "zero-k":
        s, r = s[:, :0], r[:, :0]
    elif case == "all-padding":
        s, r = torch.full((2, 4), -inf), torch.full((2, 4), -1, dtype=torch.int32)
    result = TopKResult(s, r)
    _assert_same_hits(idx.hydrate(result), _list_hydrate(ids, result))


@pytest.mark.parametrize("k", [1, 5, 27, 40])
def test_hydrate_matches_list_lookup_on_searches(tombstoned_index, k):
    # k past the 27 live rows pads with -1 and -inf
    idx, ids = tombstoned_index
    result = idx.search_batch(unit_rows(6, seed=5), k)
    got = idx.hydrate(result)
    _assert_same_hits(got, _list_hydrate(ids, result))
    assert all(len(row) == min(k, 27) for row in got)
    assert not {h.doc_id for row in got for h in row} & {"doc-2", "row-7", "row-29"}


def test_ftvi_round_trip_of_unicode_ids(tmp_path):
    ids = IDS["multibyte"][:8] + ["", "plain", "x" * 300, "混合-mixed-ü"]
    vecs = unit_rows(len(ids), seed=6)
    created = TwoTierIndex.create(
        str(tmp_path), vecs, ids, ident(), device=CPU, quality_vectors=unit_rows(len(ids), seed=7, dim=24),
        quality_identity=ident(24),
    )
    created.append_fast(["appended-é"], unit_rows(1, seed=8))
    created.delete(["plain"])
    reopened = TwoTierIndex.open(str(tmp_path), device=CPU)
    for index in (created, reopened):
        assert index.fast.doc_ids == ids + ["appended-é"] and index.quality.doc_ids == ids
        assert [index.fast.row_for(d) for d in ids] == list(range(len(ids)))
        assert index.tombstoned_ids() == {"plain"}
        np.testing.assert_array_equal(index._fast_to_quality, list(range(len(ids))) + [-1])
        hits = index.search_fast_classified(vecs[2], 3).hits
        assert hits[0].doc_id == ids[2] and hits[0].row == 2
    compacted = reopened.compact()
    assert compacted.fast.doc_ids == [d for d in ids if d != "plain"] + ["appended-é"]


def _metadata(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 4, size=n).tolist()
    stamps = rng.integers(0, 30, size=n).tolist()
    return [None if k == 3 else {"doc_type": "abc"[k], "mtime": t} for k, t in zip(kinds, stamps)]


FILTER_IDS = {
    "ascii": IDS["ascii"],
    "multibyte": IDS["multibyte"][:8] + ["", "é-last"],
    "repeated-ids": ["dup", "a", "dup", "b", "", "dup", ""],
    "none": [],
}


def _filters(ids: list) -> dict:
    allowed = frozenset(ids[::3] + ["never-indexed", "dup"])
    return {
        "bitset": BitsetFilter(allowed),
        "bitset-empty": BitsetFilter(frozenset()),
        "doc-type": DocTypeFilter(frozenset({"a", "c"})),
        "date-range": DateRangeFilter(start=5, end=20),
        "predicate": PredicateFilter(lambda d, m: d.endswith("0") or (m or {}).get("doc_type") == "b"),
        "chain": FilterChain([BitsetFilter(allowed), DateRangeFilter(end=25)]),
        "empty-chain": FilterChain(),
    }


@pytest.mark.parametrize("case", list(FILTER_IDS))
@pytest.mark.parametrize("kind", list(_filters([])))
def test_filter_masks_over_a_store_match_the_list(case, kind):
    ids = FILTER_IDS[case]
    flt, md = _filters(ids)[kind], _metadata(len(ids), seed=len(ids))
    want = flt.mask(list(ids), md)
    for store in (DocIdStore.of(ids), DocIdStore.of(ids[:2]) + ids[2:]):
        for _ in range(2):  # the first call may build the map, the second reads it
            got = flt.mask(store, md)
            assert got.dtype == bool and got.shape == (len(ids),)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["bitset", "doc-type", "date-range", "predicate", "chain"])
def test_index_filter_mask_matches_the_list(kind):
    ids = [f"d{i:03d}-ü" for i in range(50)]
    idx = DeviceVectorIndex(unit_rows(50, seed=9), ids, ident(), device=CPU).with_tombstones(["d004-ü", "d030-ü"])
    md = _metadata(50, seed=10)
    flt = _filters(ids)[kind]
    admit = flt.mask(ids, md)
    want = np.minimum(np.where(admit, 0.0, -np.inf), idx.base_mask[:50].numpy())
    got = idx._effective_mask(flt, md).numpy()
    np.testing.assert_array_equal(got[:50], want)
    assert np.all(got[50:] == -np.inf)
    hits = idx.hydrate(idx.search_batch(unit_rows(3, seed=11), 60, search_filter=flt, metadata=md))
    live = {d for d, ok, keep in zip(ids, idx._valid_host[:50], admit) if ok and keep}
    assert all({h.doc_id for h in row} == live for row in hits)


@pytest.mark.parametrize("kind", ["bitset", "doc-type", "date-range", "chain", "predicate"])
def test_only_filters_that_judge_ids_decode_them(monkeypatch, kind):
    ids = [f"d{i:05d}" for i in range(1000)]
    store = DocIdStore.of(ids)
    assert store.row_for(ids[0]) == 0  # the map exists; a query then reads no row
    flt, md = _filters(ids)[kind], _metadata(len(ids), seed=12)
    want = flt.mask(ids, md)

    def no_decode(*_args):
        raise AssertionError("a row was decoded")

    for name in ("__iter__", "__getitem__", "take"):
        monkeypatch.setattr(DocIdStore, name, no_decode)
    if kind == "predicate":  # the one filter that must read every id
        with pytest.raises(AssertionError, match="a row was decoded"):
            flt.mask(store, md)
    else:
        np.testing.assert_array_equal(flt.mask(store, md), want)


@pytest.mark.parametrize("tail_kind", ["fresh", "superseding", "repeated-in-tail", "empty"])
@pytest.mark.parametrize("built", [False, True], ids=["unbuilt", "built"])
def test_append_carries_a_built_map(tail_kind, built):
    ids = [f"r{i}-ß" for i in range(30)]
    tail = {
        "fresh": ["new-1", "new-2"],
        "superseding": ["r3-ß", "new-1", "r29-ß"],
        "repeated-in-tail": ["new-1", "new-1"],
        "empty": [],
    }[tail_kind]
    store = DocIdStore.of(ids)
    if built:
        assert store.row_for("r7-ß") == 7
    before = None if store._row_of is None else dict(store._row_of)
    grown = store + tail
    assert (grown._row_of is None) == (not built)
    as_list = ids + tail
    for doc_id in set(as_list) | {"missing"}:
        want = max((i for i, d in enumerate(as_list) if d == doc_id), default=None)
        assert grown.row_for(doc_id) == want
    np.testing.assert_array_equal(grown.isin({"r3-ß", "new-1", "missing"}), [d in {"r3-ß", "new-1"} for d in as_list])
    assert store._row_of == before and store == ids  # the old store is left as it was


def test_first_lookup_builds_the_map_once_across_threads(monkeypatch):
    store = DocIdStore.of([f"t{i}" for i in range(20_000)])
    walks = []
    plain_iter = DocIdStore.__iter__

    def counted(self):
        walks.append(1)
        return plain_iter(self)

    monkeypatch.setattr(DocIdStore, "__iter__", counted)
    gate, rows = threading.Barrier(8), []

    def look_up(i):
        gate.wait()
        rows.append((i, store.row_for(f"t{i * 999}")))

    threads = [threading.Thread(target=look_up, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(rows) == [(i, i * 999) for i in range(8)] and len(walks) == 1


def _ftvi_with_ids(tmp_path, ids) -> tuple[str, FtviHeader]:
    path = str(tmp_path / "ids.idx")
    header = write_ftvi(path, unit_rows(len(ids), seed=13), ids, ident(), dtype="f32")
    return path, header


def _poke(path: str, at: int, data: bytes) -> None:
    with open(path, "r+b") as f:
        f.seek(at)
        f.write(data)


@pytest.mark.parametrize(
    "damage", ["intact", "falling-offsets", "split-character", "bad-utf8", "end-past-blob", "lone-surrogate"]
)
def test_ftvi_doc_table_is_checked_on_open(tmp_path, damage):
    ids = ["é", "文档", "plain", "", "🙂x"]
    if damage == "lone-surrogate":  # refused when written: no reader could decode it
        with pytest.raises(UnicodeError):
            _ftvi_with_ids(tmp_path, ids + ["a\ud800"])
        return
    path, h = _ftvi_with_ids(tmp_path, ids)
    offsets = np.array([0, 2, 8, 13, 13, 18], dtype=np.uint64)
    assert h.doc_blob_len == 18 and FtviFile(path).doc_ids.offsets.tolist() == offsets.tolist()
    if damage == "falling-offsets":
        _poke(path, h.offsets_offset + 8 * 2, np.uint64(1).tobytes())
    elif damage == "split-character":  # row 1 starts inside "é"
        _poke(path, h.offsets_offset + 8, np.uint64(1).tobytes())
    elif damage == "bad-utf8":
        _poke(path, h.doc_blob_offset + 8, b"\xff")
    elif damage == "end-past-blob":
        _poke(path, h.offsets_offset + 8 * 5, np.uint64(2**63 + 5).tobytes())
    if damage == "intact":
        f = FtviFile(path)
        assert isinstance(f.doc_ids, DocIdStore) and f.doc_ids == ids and list(f.doc_ids) == ids
    else:
        with pytest.raises(IndexCorrupted, match="doc-id table unreadable"):
            FtviFile(path)
