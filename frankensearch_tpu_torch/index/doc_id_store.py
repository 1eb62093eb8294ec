"""Read-only doc-id table: one UTF-8 blob and int64 row offsets.

The layout of the FTVI artifact's doc table (index/fsvi.py): row ``i`` is
``blob[offsets[i]:offsets[i + 1]]``. Neither the ``bytes`` blob nor the
numpy offsets is tracked by CPython's cyclic collector, and nothing here
holds one Python object a row, so a full (generation-2) collector pass
walks none of an index's ids. A ``list`` of ids would put one reference a
row on every such pass: 8.84M of them at MS MARCO's scale. Rows decode on
access; the id -> row map is built on the first lookup (a dict of str ->
int, which the collector does not track either) and carried into the
stores that ``+`` makes from this one.
"""

from __future__ import annotations

import operator
import threading
from collections.abc import Iterable, Iterator, Sequence

import numpy as np

#: rows whose offsets one step of ``__iter__`` turns into Python ints
_ITER_CHUNK = 1 << 16


def _encode(doc_id: str) -> bytes:
    # surrogatepass: any Python str round-trips, a lone surrogate included
    return doc_id.encode("utf-8", "surrogatepass")


class DocIdStore(Sequence[str]):
    """An immutable sequence of doc ids packed into one blob.

    Rows are read by index, slice, iteration or :meth:`take` (many rows at
    once); :meth:`row_for` maps an id back to its row (the last row that
    holds it). ``store + ids`` appends rows without decoding the old ones.
    A store equals another store or a ``list`` with the same ids in the
    same order."""

    __slots__ = ("_blob", "_offsets", "_row_of", "_unique", "_lock")

    def __init__(self, blob: bytes, offsets: np.ndarray) -> None:
        offsets = np.asarray(offsets, dtype=np.int64)
        if offsets.ndim != 1 or not offsets.size or offsets[0] != 0 or offsets[-1] != len(blob):
            raise ValueError(f"offsets must run from 0 to the blob's {len(blob)} bytes")
        self._blob = bytes(blob)
        self._offsets = offsets
        self._row_of: dict[str, int] | None = None
        self._unique = True  # no id on two rows (known once the map is built)
        self._lock = threading.Lock()

    @property
    def blob(self) -> bytes:
        """The ids' UTF-8 bytes, row after row."""
        return self._blob

    @property
    def offsets(self) -> np.ndarray:
        """``len + 1`` int64 byte offsets into :attr:`blob` (read only)."""
        view = self._offsets.view()
        view.flags.writeable = False
        return view

    @classmethod
    def from_packed(cls, blob: bytes, offsets: np.ndarray) -> "DocIdStore":
        """A store over a stored blob and offsets, checked once: the offsets
        never fall, and every row is strict UTF-8 (ValueError otherwise)."""
        store = cls(blob, offsets)
        starts = store._offsets[:-1]
        if np.any(starts > store._offsets[1:]):
            raise ValueError("doc-id offsets fall")
        blob.decode("utf-8")  # the whole blob, in C
        # a row boundary inside a character would leave both rows undecodable
        inner = starts[starts < len(blob)]
        if np.any(np.frombuffer(blob, dtype=np.uint8)[inner] & 0xC0 == 0x80):
            raise ValueError("a doc-id offset splits a UTF-8 character")
        return store

    @classmethod
    def of(cls, doc_ids: Iterable[str]) -> "DocIdStore":
        """``doc_ids`` packed (a store is returned as it is)."""
        if isinstance(doc_ids, DocIdStore):
            return doc_ids
        ids = doc_ids if isinstance(doc_ids, list) else list(doc_ids)
        text = "".join(ids)
        blob = _encode(text)
        if len(blob) == len(text):  # all ASCII: a row's bytes are its characters
            lengths = np.fromiter(map(len, ids), dtype=np.int64, count=len(ids))
        else:
            lengths = np.fromiter((len(_encode(d)) for d in ids), dtype=np.int64, count=len(ids))
        offsets = np.zeros(len(ids) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        return cls(blob, offsets)

    def __len__(self) -> int:
        return len(self._offsets) - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self.take(np.arange(*i.indices(len(self))))
        n = len(self)
        row = operator.index(i)
        if row < 0:
            row += n
        if not 0 <= row < n:
            raise IndexError("doc-id row out of range")
        a, b = self._offsets[row : row + 2].tolist()
        return self._blob[a:b].decode("utf-8", "surrogatepass")

    def __iter__(self) -> Iterator[str]:
        blob = self._blob
        for start in range(0, len(self), _ITER_CHUNK):
            offs = self._offsets[start : start + _ITER_CHUNK + 1].tolist()
            for a, b in zip(offs, offs[1:]):
                yield blob[a:b].decode("utf-8", "surrogatepass")

    def __contains__(self, doc_id: object) -> bool:
        return isinstance(doc_id, str) and self.row_for(doc_id) is not None

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DocIdStore):
            return self._blob == other._blob and np.array_equal(self._offsets, other._offsets)
        if isinstance(other, list):
            return len(other) == len(self) and all(a == b for a, b in zip(self, other))
        return NotImplemented

    def __add__(self, doc_ids: Iterable[str]) -> "DocIdStore":
        """A new store of these rows, then ``doc_ids``. A built id -> row map
        is copied over with the new rows set (a later row wins, as in
        :meth:`row_for`), so the new store never decodes the old rows."""
        tail = DocIdStore.of(doc_ids)
        offsets = np.concatenate([self._offsets, tail._offsets[1:] + len(self._blob)])
        grown = DocIdStore(self._blob + tail._blob, offsets)
        if self._row_of is not None:
            row_of = dict(self._row_of)
            for row, doc_id in enumerate(tail, start=len(self)):
                row_of[doc_id] = row
            grown._unique = self._unique and len(row_of) == len(grown)
            grown._row_of = row_of
        return grown

    def take(self, rows) -> list[str]:
        """The ids of ``rows`` (an int array of any shape, read in C order;
        every row in ``[0, len)``: the caller drops padding first)."""
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        if rows.size and rows.min() < 0:
            raise IndexError("negative doc-id row")
        starts = self._offsets[rows].tolist()
        ends = self._offsets[rows + 1].tolist()
        blob = self._blob
        return [blob[a:b].decode("utf-8", "surrogatepass") for a, b in zip(starts, ends)]

    def _map(self) -> dict[str, int]:
        """The id -> row map, built under the store's lock on first use so
        that threads sharing an index build it once."""
        row_of = self._row_of
        if row_of is None:
            with self._lock:
                row_of = self._row_of
                if row_of is None:
                    row_of = {d: i for i, d in enumerate(self)}
                    self._unique = len(row_of) == len(self)
                    self._row_of = row_of
        return row_of

    def row_for(self, doc_id: str) -> int | None:
        """The row of ``doc_id`` (its last, if it repeats), or None. The
        map is built on the first call and kept."""
        return self._map().get(doc_id)

    def isin(self, doc_ids: Iterable[str]) -> np.ndarray:
        """A bool per row: is its id one of ``doc_ids``? Looks each of
        ``doc_ids`` up in the map and decodes no row, unless some id sits on
        two rows; then every row is read."""
        row_of = self._map()
        out = np.zeros(len(self), dtype=bool)
        if self._unique:
            rows = [r for r in map(row_of.get, doc_ids) if r is not None]
            out[np.asarray(rows, dtype=np.int64)] = True
        else:
            wanted = doc_ids if isinstance(doc_ids, (set, frozenset)) else set(doc_ids)
            out[:] = np.fromiter((d in wanted for d in self), dtype=bool, count=len(self))
        return out
