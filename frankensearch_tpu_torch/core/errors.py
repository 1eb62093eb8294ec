"""Typed search errors.

Parity target: reference crates/frankensearch-core/src/error.rs (SearchError
enum: EmbeddingFailed, SearchTimeout, Cancelled, DimensionMismatch,
IndexCorrupted, SubsystemError, InvalidConfig, ...).
"""

from __future__ import annotations


class SearchError(Exception):
    """Base class for all typed frankensearch-tpu errors."""

    #: stable machine-readable code, mirrored in CLI error envelopes
    code: str = "search_error"

    def __init__(self, message: str = "", **context: object) -> None:
        super().__init__(message)
        self.message = message
        self.context = context

    def __str__(self) -> str:  # pragma: no cover - trivial
        if self.context:
            ctx = ", ".join(f"{k}={v!r}" for k, v in sorted(self.context.items()))
            return f"{self.message} ({ctx})"
        return self.message


class EmbeddingFailed(SearchError):
    """An embedder failed to produce a vector."""

    code = "embedding_failed"


class SearchTimeout(SearchError):
    """A phase exceeded its budget (e.g. quality_timeout_ms)."""

    code = "search_timeout"


class Cancelled(SearchError):
    """The caller cancelled the operation."""

    code = "cancelled"


class DimensionMismatch(SearchError):
    """Query/index embedding dimensions disagree."""

    code = "dimension_mismatch"

    def __init__(self, expected: int, actual: int, message: str = "") -> None:
        super().__init__(
            message or f"dimension mismatch: expected {expected}, got {actual}",
            expected=expected,
            actual=actual,
        )
        self.expected = expected
        self.actual = actual


class IndexCorrupted(SearchError):
    """An index artifact failed checksum/identity verification."""

    code = "index_corrupted"


class IndexNotFound(SearchError):
    """No index artifact at the given path."""

    code = "index_not_found"


class SubsystemError(SearchError):
    """A wrapped error from a lower layer (storage, device runtime, ...)."""

    code = "subsystem_error"


class InvalidConfig(SearchError):
    """Configuration failed validation."""

    code = "invalid_config"


class IdentityMismatch(SearchError):
    """Embedding identity (embedder id/revision/dim) does not match the
    index artifact's identity binding (fail-closed semantic admission).

    Parity: reference FSVI v2 identity binding (index/src/lib.rs:263) and
    admit_semantic_query (fusion/src/searcher.rs:969).
    """

    code = "identity_mismatch"


class UncertifiedScanMode(SearchError):
    """An approximate scan mode was requested with fail-closed
    certification on, but no recall certificate covering the request
    meets the configured floor (recall_certificate.rs parity: the
    capacity lane refuses to serve un-certified configs)."""

    code = "uncertified_scan_mode"


class WalCorrupted(SearchError):
    """A WAL batch failed its CRC check (partial writes are discarded)."""

    code = "wal_corrupted"
