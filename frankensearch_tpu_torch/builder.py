"""Facade: fluent IndexBuilder + open_hybrid.

Parity target: reference frankensearch/src/index_builder.rs:184 —
``IndexBuilder``: auto-detect embedder stack (degraded-stack warning:
hash-built generations are permanently non-semantic, :311-323), batch
embed fast + quality with per-doc failure recording, build vector
artifacts + lexical arm, return ``IndexBuildStats`` with per-arm
accounting; ``open_hybrid`` opens every arm + the active lexical reader.

The port's copy of frankensearch_tpu/builder.py. ``IndexBuilder`` and
``open_hybrid`` run on the device the caller names (``device="cuda"`` by
default; ``"cpu"`` runs the kernels' plain twins), and none of the
reference's fallbacks that would hide a device failure is carried over:
a failure of the Model2Vec bag lane raises (the per-batch loop with
per-doc errors is only for an embedder's own ``embed_batch`` failures),
the packed lexical arm is skipped only when the native postings builder
does not apply (``NativePostingsUnavailable``), and ``mesh_shards > 0``
(the mesh-sharded arms) raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
import sqlite3
import time
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

from frankensearch_tpu_torch.core.canonicalize import DefaultCanonicalizer
from frankensearch_tpu_torch.core.config import TwoTierConfig
from frankensearch_tpu_torch.core.errors import IndexCorrupted, IndexNotFound
from frankensearch_tpu_torch.core.types import IndexableDocument
from frankensearch_tpu_torch.device import resolve_device
from frankensearch_tpu_torch.embed.base import Embedder
from frankensearch_tpu_torch.embed.stack import EmbedderStack
from frankensearch_tpu_torch.fusion.searcher import TwoTierSearcher
from frankensearch_tpu_torch.index.two_tier import TwoTierIndex
from frankensearch_tpu_torch.lexical.memory_index import MemoryLexicalIndex
from frankensearch_tpu_torch.lexical.persist import load_lexical, save_lexical
from frankensearch_tpu_torch.storage.store import Storage


@dataclass
class IndexSizeBreakdown:
    """Per-arm byte accounting (index_builder.rs:60-80)."""

    fast_vector_bytes: int = 0
    quality_vector_bytes: int = 0
    lexical_bytes: int = 0
    storage_bytes: int = 0

    @property
    def total_bytes(self) -> int:
        return (
            self.fast_vector_bytes
            + self.quality_vector_bytes
            + self.lexical_bytes
            + self.storage_bytes
        )


@dataclass
class IndexBuildStats:
    doc_count: int = 0
    error_count: int = 0
    skipped_low_signal: int = 0
    superseded_duplicates: int = 0
    duration_ms: float = 0.0
    warnings: list[str] = field(default_factory=list)
    per_doc_errors: dict[str, str] = field(default_factory=dict)
    sizes: IndexSizeBreakdown = field(default_factory=IndexSizeBreakdown)
    semantic: bool = True


def _refuse_mesh(config: TwoTierConfig) -> None:
    if config.mesh_shards > 0:
        raise NotImplementedError(
            "mesh_shards > 0: the mesh-sharded vector and lexical arms are not "
            "ported yet (ROADMAP queue 1, item 4: multi-GPU)"
        )


class IndexBuilder:
    """Fluent corpus -> hybrid index builder on one device."""

    def __init__(self, root: str, *, device="cuda") -> None:
        self.root = root
        self.device = resolve_device(device)
        self._docs: list[IndexableDocument] = []
        self._stack: EmbedderStack | None = None
        self._config = TwoTierConfig()
        self._batch_size = 64
        self._with_lexical = True
        self._with_storage = True
        self._canonicalizer = DefaultCanonicalizer()

    # fluent config ---------------------------------------------------------

    def with_documents(self, docs: Iterable[IndexableDocument]) -> "IndexBuilder":
        self._docs.extend(docs)
        return self

    def add_document(self, doc: IndexableDocument) -> "IndexBuilder":
        self._docs.append(doc)
        return self

    def with_embedder_stack(self, stack: EmbedderStack) -> "IndexBuilder":
        self._stack = stack
        return self

    def with_config(self, config: TwoTierConfig) -> "IndexBuilder":
        self._config = config.validate()
        return self

    def with_batch_size(self, n: int) -> "IndexBuilder":
        self._batch_size = max(1, n)
        return self

    def without_lexical(self) -> "IndexBuilder":
        self._with_lexical = False
        return self

    def without_storage(self) -> "IndexBuilder":
        self._with_storage = False
        return self

    # build --------------------------------------------------------------------

    def build(self) -> IndexBuildStats:
        t0 = time.monotonic()
        _refuse_mesh(self._config)
        stats = IndexBuildStats()
        stack = self._stack or EmbedderStack.auto_detect(self.root, device=self.device)
        stats.warnings.extend(stack.availability.warnings)
        stats.semantic = stack.fast.is_semantic
        if not stack.fast.is_semantic:
            stats.warnings.append(
                "building with a non-semantic (hash) fast embedder: this "
                "generation is permanently non-semantic (index_builder.rs:311)"
            )
        os.makedirs(self.root, exist_ok=True)

        # canonicalize + filter; duplicate doc_ids within one build are
        # an UPSERT (last occurrence wins — index_builder.rs upsert
        # semantics). Without this, the positional bulk lanes (fast slab
        # rows, BulkDeviceBm25Index postings) would keep BOTH versions
        # live and stale terms would still match.
        kept_by_id: dict[str, tuple[IndexableDocument, str]] = {}
        for doc in self._docs:
            canonical, cstats = self._canonicalizer.canonicalize_document_with_stats(
                doc.content
            )
            if cstats.low_signal:
                stats.skipped_low_signal += 1
                continue
            if doc.doc_id in kept_by_id:
                stats.superseded_duplicates += 1
            kept_by_id[doc.doc_id] = (doc, canonical)
        kept: list[tuple[IndexableDocument, str]] = list(kept_by_id.values())

        # embed: whole-corpus bulk lane first (the native bag-of-words lane
        # of a Model2Vec embedder, on the device: a failure there raises),
        # else one chunked embed_batch pass, with the per-batch loop as the
        # failure-isolating fallback that records per-doc errors
        # (index_builder.rs:351-420)
        texts_all = [c for _, c in kept]
        fast_vecs: list[np.ndarray] = []
        quality_vecs: list[np.ndarray] = []
        good: list[tuple[IndexableDocument, str]] = []
        fast_arr: np.ndarray | None = None
        if kept:
            from frankensearch_tpu_torch.embed.bulk import bag_embed_corpus, embed_batches
            from frankensearch_tpu_torch.embed.model2vec import Model2VecEmbedder

            wire_dtype = "bf16" if self._config.slab_dtype == "bf16" else "f32"
            if isinstance(stack.fast, Model2VecEmbedder):
                fast_arr = bag_embed_corpus(stack.fast, texts_all, wire_dtype=wire_dtype)
            if fast_arr is None:
                try:
                    fast_arr = embed_batches(stack.fast, texts_all)
                except Exception as e:
                    stats.warnings.append(
                        f"bulk embed lane failed: {type(e).__name__}: {e}; "
                        "falling back to per-batch embedding"
                    )
        if fast_arr is not None:
            good = list(kept)
            if stack.has_quality:
                try:
                    for start in range(0, len(texts_all), self._batch_size):
                        quality_vecs.extend(
                            stack.quality.embed_batch(
                                texts_all[start : start + self._batch_size]
                            )
                        )
                except Exception as e:
                    quality_vecs = []
                    stats.warnings.append(
                        f"quality embed failed: {type(e).__name__}: {e}"
                    )
        else:
            for start in range(0, len(kept), self._batch_size):
                batch = kept[start : start + self._batch_size]
                texts = [c for _, c in batch]
                try:
                    fv = stack.fast.embed_batch(texts)
                except Exception as e:
                    for doc, _ in batch:
                        stats.per_doc_errors[doc.doc_id] = f"fast: {type(e).__name__}"
                        stats.error_count += 1
                    continue
                qv = None
                if stack.has_quality:
                    try:
                        qv = stack.quality.embed_batch(texts)
                    except Exception as e:
                        stats.warnings.append(
                            f"quality embed failed: {type(e).__name__}: {e}"
                        )
                for i, (doc, canonical) in enumerate(batch):
                    fast_vecs.append(fv[i])
                    if qv is not None:
                        quality_vecs.append(qv[i])
                    good.append((doc, canonical))
            fast_arr = (
                np.stack(fast_vecs)
                if fast_vecs
                else np.zeros((0, stack.fast.dim), np.float32)
            )

        if fast_arr is None:  # empty corpus
            fast_arr = np.zeros((0, stack.fast.dim), np.float32)
        doc_ids = [d.doc_id for d, _ in good]
        stats.doc_count = len(doc_ids)
        q_arr = np.stack(quality_vecs) if quality_vecs and len(quality_vecs) == len(good) else None
        TwoTierIndex.create(
            self.root,
            fast_arr,
            doc_ids,
            stack.fast.identity(),
            device=self.device,
            quality_vectors=q_arr,
            quality_identity=stack.quality.identity() if (q_arr is not None and stack.quality) else None,
            slab_dtype=self._config.slab_dtype,  # create() quantizes int8 itself
        )

        # lexical arm (embed-independent: all kept docs, index_builder.rs:474)
        if self._with_lexical and self._config.lexical_backend == "fts5":
            # alternative engine (fts5_adapter.rs): ONE sqlite artifact,
            # MVCC writes, searchable at commit — replaces the
            # oracle-JSON + packed-FLXB pair entirely
            from frankensearch_tpu_torch.lexical.fts5_adapter import Fts5LexicalIndex

            lex_dir = os.path.join(self.root, "lexical")
            os.makedirs(lex_dir, exist_ok=True)
            fts = Fts5LexicalIndex(os.path.join(lex_dir, "fts5.db"))
            for doc, canonical in kept:
                fts.add_document(
                    IndexableDocument(
                        doc_id=doc.doc_id, content=canonical,
                        title=doc.title, metadata=doc.metadata,
                    )
                )
            fts.commit()
            fts.close()
        elif self._with_lexical:
            lex_docs = [
                IndexableDocument(
                    doc_id=doc.doc_id, content=canonical,
                    title=doc.title, metadata=doc.metadata,
                )
                for doc, canonical in kept
            ]
            lexical = MemoryLexicalIndex()
            for d in lex_docs:
                lexical.add_document(d)
            lexical.commit()
            generation = save_lexical(lexical, self.root)
            # packed device arm (FLXB) alongside the oracle snapshot:
            # open_hybrid prefers it for the read path (zero-parse load,
            # batched device BM25); where the native postings builder does
            # not apply (no native kernel, text it cannot tokenize) the
            # JSON arm serves alone, with a warning
            from frankensearch_tpu_torch.lexical.device_bm25 import (
                BulkDeviceBm25Index,
                NativePostingsUnavailable,
            )
            from frankensearch_tpu_torch.lexical.persist import save_packed_lexical

            try:
                bulk = BulkDeviceBm25Index(lex_docs, device=self.device)
            except NativePostingsUnavailable as e:
                stats.warnings.append(
                    f"packed lexical arm skipped: {type(e).__name__}: {e}"
                )
            else:
                save_packed_lexical(bulk, self.root, generation=generation)
                del bulk
            from frankensearch_tpu_torch.lexical.persist import prune_generations

            prune_generations(self.root)  # blue-green retention (keep 2)

        # storage arm
        if self._with_storage:
            try:
                storage = Storage(os.path.join(self.root, "metadata.db"))
                storage.upsert_documents_bulk(
                    (
                        (doc.doc_id, canonical, doc.title, doc.metadata)
                        for doc, canonical in kept
                    ),
                    embedder_id=stack.fast.embedder_id,
                )
                stats.duration_ms = (time.monotonic() - t0) * 1000.0
                storage.record_build(
                    stats.doc_count, stats.error_count, stats.duration_ms,
                    detail={"semantic": stats.semantic},
                )
                storage.close()
            except (sqlite3.OperationalError, OSError) as e:
                # vector + lexical arms already published good artifacts;
                # surface the storage failure TYPED (ENOSPC lands here as
                # a raw sqlite "database or disk is full" otherwise).
                # Best-effort re-census first: the manifest still
                # describes the PREVIOUS build's artifacts, and a stale
                # census fails verify_generation on the healthy new ones.
                try:
                    from frankensearch_tpu_torch.core.generation import refresh_manifest

                    refresh_manifest(self.root)
                except Exception:
                    pass  # full disk: the stale manifest stays; activation flows re-verify
                from frankensearch_tpu_torch.core.errors import SubsystemError

                raise SubsystemError(
                    f"storage arm failed after vector/lexical publication: "
                    f"{type(e).__name__}: {e} — index artifacts are "
                    "servable; free disk space and rebuild to restore "
                    "metadata"
                ) from e

        # durability: protect-on-commit — checksum sidecar (verify fast
        # path) + XOR parity-stripe sidecar (repair-on-open), covering the
        # FTVI tiers and the packed FLXB lexical arm
        # (fsvi_protector.rs / tantivy_wrapper.rs protect-on-commit roles)
        from frankensearch_tpu_torch.index.durability import protect_artifact

        for fname in ("vector.fast.idx", "vector.quality.idx"):
            path = os.path.join(self.root, fname)
            if os.path.exists(path):
                protect_artifact(path)
        lex_current = os.path.join(self.root, "lexical", "CURRENT")
        if os.path.exists(lex_current):
            with open(lex_current) as f:
                gen = f.read().strip()
            flexb = os.path.join(self.root, "lexical", gen, "index.flexb")
            if os.path.exists(flexb):
                protect_artifact(flexb)

        # generation manifest: artifact census + embedder identities +
        # golden-vector conformance certificates (generation.rs:1-6), so
        # a drop-in embedder claiming the same id is verifiable to
        # produce the same space before it serves (quality parity
        # turnkey: real weights validate on arrival, VERDICT r1 item 5)
        try:
            from frankensearch_tpu_torch.core.generation import (
                EmbedderConformanceCertificate,
                build_manifest,
                write_manifest,
            )

            certs = {"fast": EmbedderConformanceCertificate.compute(stack.fast).to_dict()}
            embedder_ids = {"fast": stack.fast.identity().to_dict()}
            if stack.has_quality and stack.quality is not None:
                certs["quality"] = EmbedderConformanceCertificate.compute(
                    stack.quality
                ).to_dict()
                embedder_ids["quality"] = stack.quality.identity().to_dict()
            manifest = build_manifest(
                self.root,
                generation_id=f"gen-{int(time.time() * 1000):013d}",
                commit_seq=int(time.time() * 1000),
                embedders=embedder_ids,
                doc_count=stats.doc_count,
                quantization=self._config.slab_dtype,
            )
            manifest.extra["conformance"] = certs
            write_manifest(self.root, manifest)
        except Exception as e:
            stats.warnings.append(f"manifest skipped: {type(e).__name__}: {e}")

        stats.sizes = _measure_sizes(self.root)
        stats.duration_ms = (time.monotonic() - t0) * 1000.0
        return stats


def _measure_sizes(root: str) -> IndexSizeBreakdown:
    def size_of(path: str) -> int:
        return os.path.getsize(path) if os.path.exists(path) else 0

    lexical_bytes = 0
    lex_root = os.path.join(root, "lexical")
    if os.path.isdir(lex_root):
        for dirpath, _, files in os.walk(lex_root):
            lexical_bytes += sum(size_of(os.path.join(dirpath, f)) for f in files)
    return IndexSizeBreakdown(
        fast_vector_bytes=size_of(os.path.join(root, "vector.fast.idx")),
        quality_vector_bytes=size_of(os.path.join(root, "vector.quality.idx")),
        lexical_bytes=lexical_bytes,
        storage_bytes=size_of(os.path.join(root, "metadata.db")),
    )


@dataclass
class HybridHandle:
    """Everything open_hybrid opened (index_builder.rs open_hybrid)."""

    index: TwoTierIndex
    #: the active lexical arm's snapshot-of-record: the in-memory oracle
    #: (standard backend) or the FTS5 engine (lexical_backend="fts5")
    lexical: "MemoryLexicalIndex | object | None"
    storage: Storage | None
    searcher: TwoTierSearcher
    #: lease-bounded searchable-before-seal write path (quill delta.rs);
    #: writers go through this so appends are visible WITHOUT a
    #: per-batch packed republish — seal() folds them into a fresh
    #: FLXB generation when the lease budget trips or at flow exit
    delta: "DeltaLexicalIndex | None" = None

    def close(self) -> None:
        """Release process-local resources (worker pool, sqlite handle).
        Artifacts/indices stay valid on disk."""
        self.searcher.close()
        if self.storage is not None:
            self.storage.close()

    def __enter__(self) -> "HybridHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def delete(self, doc_ids) -> None:
        """Tombstone docs across EVERY arm: vector tiers (durable via
        WAL), lexical (through the delta so the removal is searchable
        before the next seal), and storage. The searcher additionally
        enforces cross-arm supersession, so even a stale lexical
        generation cannot resurface a vector-tombstoned doc."""
        self.index.delete(list(doc_ids))
        if self.delta is not None:
            for doc_id in doc_ids:
                self.delta.delete_document(doc_id)
            self.delta.commit()
        if self.storage is not None:
            for doc_id in doc_ids:
                self.storage.delete_document(doc_id)


def _verify_embedder_conformance(root: str, *, fast, quality) -> None:
    from frankensearch_tpu_torch.core.errors import IdentityMismatch
    from frankensearch_tpu_torch.core.generation import (
        MANIFEST_FILE,
        EmbedderConformanceCertificate,
        read_manifest,
    )

    if not os.path.exists(os.path.join(root, MANIFEST_FILE)):
        return
    try:
        manifest = read_manifest(root)
    except Exception:
        return  # artifact census problems surface through durability, not here
    certs = manifest.extra.get("conformance", {})
    for tier, emb in (("fast", fast), ("quality", quality)):
        raw = certs.get(tier)
        if emb is None or raw is None:
            continue
        cert = EmbedderConformanceCertificate.from_dict(raw)
        if cert.embedder_id != emb.embedder_id:
            continue  # different identity: the searcher's admission handles it
        ok, worst = cert.verify(emb)
        if not ok:
            raise IdentityMismatch(
                f"{tier} embedder {emb.embedder_id!r} fails golden-vector "
                f"conformance (worst probe cosine {worst:.4f} < "
                f"{cert.min_cosine}): same id, different space — refusing "
                "to serve a silently wrong semantic lane"
            )


def _open_storage_degraded(db_path: str) -> "Storage | None":
    """Open the metadata store for serving, degrading instead of failing.

    Storage itself falls back to a read-only handle on a full/read-only
    filesystem; if even that fails (e.g. the sqlite WAL needs recovery
    and the disk is full), serving WITHOUT hydration metadata still
    beats refusing to open — the artifacts are verified independently.
    (Probed: ENOSPC after a failed rebuild made open_hybrid raise a raw
    sqlite3.OperationalError with every artifact intact.)"""
    if not os.path.exists(db_path):
        return None
    try:
        return Storage(db_path)
    except Exception as e:
        import logging

        logging.getLogger("frankensearch").warning(
            "metadata store unopenable (%s: %s) — serving without "
            "storage-backed hydration/history", type(e).__name__, e
        )
        return None


def open_hybrid(
    root: str,
    fast_embedder: Embedder | None = None,
    quality_embedder: Embedder | None = None,
    *,
    config: TwoTierConfig | None = None,
    embedder_wrap=None,
    device="cuda",
    **searcher_kwargs,
) -> HybridHandle:
    """Open all arms at ``root`` and assemble a ready searcher.

    When no fast embedder is supplied, a stack is auto-detected against
    the root; identity admission in the searcher stays fail-closed.

    ``embedder_wrap``: optional ``Embedder -> Embedder`` applied to the
    fast embedder AFTER auto-detection but BEFORE golden-vector
    conformance — the hook for transport decorators like
    ``DaemonFallbackEmbedder`` (fusion/daemon_fallback.py; parity:
    reference daemon_fallback.rs). Conformance runs through the wrapper,
    so a daemon serving a different model space is caught fail-closed.

    Every arm opens on ``device`` (``"cuda"`` unless the caller asks for
    ``"cpu"``).
    """
    cfg = (config or TwoTierConfig.from_env()).validate()
    _refuse_mesh(cfg)
    dev = resolve_device(device)

    def _open_index() -> TwoTierIndex:
        idx = TwoTierIndex.open(
            root, device=dev,
            slab_dtype=cfg.slab_dtype if cfg.slab_dtype != "int8" else "bf16",
        )
        idx.wal_sync = cfg.wal_sync
        return idx

    try:
        index = _open_index()
    except IndexCorrupted:
        # durability ladder, last rung: parity repair already failed
        # inside open — quarantine the corrupt artifact and rebuild a
        # servable fast tier from WAL + storage (reingest jobs for docs
        # whose vectors are unrecoverable). index/rebuild.py docstring
        # explains why this is the truthful recovery, not re-embedding.
        from frankensearch_tpu_torch.index.durability import ProtectedArtifactStore
        from frankensearch_tpu_torch.index.rebuild import rebuild_fast_tier_from_wal
        from frankensearch_tpu_torch.index.two_tier import TwoTierPaths

        fast_path = TwoTierPaths(root).fast
        store = ProtectedArtifactStore(root)
        store.quarantine(os.path.basename(fast_path))
        report = rebuild_fast_tier_from_wal(root, artifact=fast_path)
        if not report.rebuilt:
            raise
        index = _open_index()
    if fast_embedder is None:
        stack = EmbedderStack.auto_detect(root, device=dev)
        fast_embedder = stack.fast
        quality_embedder = quality_embedder or stack.quality
        # auto-detected hash embedder must match the index identity dims
        if (
            not fast_embedder.is_semantic
            and index.fast.identity.embedder_id.startswith("hash-")
            and fast_embedder.dim != index.fast.identity.dim
        ):
            from frankensearch_tpu_torch.embed.hash_embedder import HashEmbedder

            fast_embedder = HashEmbedder(dim=index.fast.identity.dim)
    if embedder_wrap is not None:
        fast_embedder = embedder_wrap(fast_embedder)
    # golden-vector conformance (fail-closed admission): an embedder
    # claiming the build-time identity must reproduce the pinned probe
    # space — catches same-id-different-weights drift that identity-id
    # admission alone cannot (generation.rs golden-vector certificates)
    _verify_embedder_conformance(root, fast=fast_embedder, quality=quality_embedder)
    # alternative FTS5 engine: opened when the build produced it (auto)
    # or the config demands it; it is LexicalRead+Write with MVCC
    # commits, so it serves as searcher arm AND its own delta
    fts5_db = os.path.join(root, "lexical", "fts5.db")
    if cfg.lexical_backend == "fts5" or (
        cfg.lexical_backend == "auto" and os.path.exists(fts5_db)
    ):
        from frankensearch_tpu_torch.lexical.fts5_adapter import Fts5LexicalIndex

        if not os.path.exists(fts5_db):
            raise IndexNotFound(
                f"lexical_backend='fts5' but no {fts5_db}; "
                f"build with TwoTierConfig(lexical_backend='fts5')"
            )
        fts = Fts5LexicalIndex(fts5_db)
        db_path = os.path.join(root, "metadata.db")
        storage = _open_storage_degraded(db_path)
        if storage is not None and "text_fn" not in searcher_kwargs:
            def _storage_text_f(doc_id: str, _s=storage) -> str | None:
                row = _s.get_document(doc_id)
                if row is None:
                    return None
                parts = [p for p in (row.title, row.preview) if p]
                return " ".join(parts) or None

            searcher_kwargs["text_fn"] = _storage_text_f
        if "control_plane" not in searcher_kwargs:
            from frankensearch_tpu_torch.fusion.control_plane import build_control_plane

            cp = build_control_plane(cfg, root)
            if cp is not None:
                searcher_kwargs["control_plane"] = cp
        searcher = TwoTierSearcher(
            index, fast_embedder, lexical=fts,
            quality_embedder=quality_embedder, config=cfg, **searcher_kwargs,
        )
        return HybridHandle(
            # the FTS5 engine IS the lexical arm — handle.lexical None
            # here made serve's status report lexical:false while lexical
            # results were being served (review finding)
            index=index, lexical=fts, storage=storage, searcher=searcher,
            delta=fts,
        )
    try:
        lexical = load_lexical(root)
    except IndexCorrupted:
        # degradation ladder: a corrupt lexical oracle snapshot must not
        # kill the open — the vector arms (and the packed lexical arm,
        # which verifies independently) keep serving
        lexical = None
    # read path: the packed FLXB device arm (zero-parse load + batched
    # device scoring) wrapped in the lease-bounded delta (quill delta.rs)
    # so writes through handle.delta are searchable BEFORE the next
    # packed seal; the oracle arm remains the snapshot of record
    from frankensearch_tpu_torch.lexical.delta import DeltaLexicalIndex
    from frankensearch_tpu_torch.lexical.persist import load_packed_lexical

    packed = load_packed_lexical(root, device=dev)
    delta = None
    if lexical is not None:
        delta = DeltaLexicalIndex(lexical, sealed=packed, root=root, device=dev)
    db_path = os.path.join(root, "metadata.db")
    storage = _open_storage_degraded(db_path)
    if storage is not None and "text_fn" not in searcher_kwargs:
        # storage-backed doc text (preview+title): powers the negation
        # exclusion filter ("alpha -fresh") and phase-3 rerank without
        # the caller threading a text_fn per search() call. Previews
        # truncate long docs — negation terms beyond the preview window
        # are invisible to the filter (the documented "available text"
        # contract).
        def _storage_text(doc_id: str, _s=storage) -> str | None:
            row = _s.get_document(doc_id)
            if row is None:
                return None
            parts = [p for p in (row.title, row.preview) if p]
            return " ".join(parts) or None

        searcher_kwargs["text_fn"] = _storage_text
    if "control_plane" not in searcher_kwargs:
        # adaptive/conformal/calibration controls demanded by the config
        # (fusion/control_plane.py); state persists under the root so CLI
        # feedback accumulates across invocations
        from frankensearch_tpu_torch.fusion.control_plane import build_control_plane

        cp = build_control_plane(cfg, root)
        if cp is not None:
            searcher_kwargs["control_plane"] = cp
    # quality rank kernels demanded by the config (searcher.rs:312-868
    # with_* options; pre-wiring these were tested library code with no
    # construction path from the product — the VERDICT r2 adaptive gap
    # class): PRF query expansion, MMR diversification, hubness
    # correction, PageRank graph source.
    if cfg.prf_enabled and "prf" not in searcher_kwargs:
        from frankensearch_tpu_torch.fusion.prf import RocchioPrf

        searcher_kwargs["prf"] = RocchioPrf()
    if cfg.mmr_lambda is not None and "mmr" not in searcher_kwargs:
        from frankensearch_tpu_torch.fusion.mmr import MmrDiversifier

        searcher_kwargs["mmr"] = MmrDiversifier(lambda_relevance=cfg.mmr_lambda)
    if (cfg.hubness_beta > 0.0 and "hubness" not in searcher_kwargs) or (
        cfg.neighbor_smoothing and "smoother" not in searcher_kwargs
    ):
        # both need the O(N^2) all-pairs similarity precompute over the
        # slab; share the guard (and the vectors) between them
        n = index.fast.n_rows
        if n <= cfg.hubness_max_docs:
            vecs = index.fast.vectors_f32()
            if cfg.hubness_beta > 0.0 and "hubness" not in searcher_kwargs:
                from frankensearch_tpu_torch.fusion.hubness import (
                    HubnessCorrector,
                    build_hubness_scores,
                )

                searcher_kwargs["hubness"] = HubnessCorrector(
                    beta=cfg.hubness_beta,
                    scores_by_row=build_hubness_scores(vecs),
                )
            if cfg.neighbor_smoothing and "smoother" not in searcher_kwargs:
                from frankensearch_tpu_torch.fusion.hubness import (
                    ScoreSmoother,
                    build_neighbor_lists,
                )

                searcher_kwargs["smoother"] = ScoreSmoother(
                    alpha=cfg.smoothing_alpha,
                    neighbors_by_row=build_neighbor_lists(
                        vecs, k=cfg.smoothing_neighbors
                    ),
                )
        else:
            import warnings

            warnings.warn(
                f"hubness/smoothing skipped: {n} docs exceeds "
                f"hubness_max_docs={cfg.hubness_max_docs} (O(N^2) precompute)",
                stacklevel=2,
            )
    if cfg.graph_rank and storage is not None and "graph_ranker" not in searcher_kwargs:
        from frankensearch_tpu_torch.core.graph import DocumentGraph
        from frankensearch_tpu_torch.fusion.graph_rank import GraphRanker

        g = DocumentGraph()
        for row in storage.iter_documents():
            links = (row.metadata or {}).get("links")
            if isinstance(links, (list, tuple)):
                for dst in links:
                    if isinstance(dst, str) and dst:
                        g.add_edge(row.doc_id, dst)
        if g.edge_count() > 0:
            searcher_kwargs["graph_ranker"] = GraphRanker(g)
    searcher = TwoTierSearcher(
        index,
        fast_embedder,
        lexical=delta if delta is not None else packed,
        quality_embedder=quality_embedder,
        config=cfg,
        **searcher_kwargs,
    )
    return HybridHandle(
        index=index, lexical=lexical, storage=storage, searcher=searcher,
        delta=delta,
    )
