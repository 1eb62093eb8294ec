"""Cross-component contract lockstep validation + observability lint.

Parity targets (reference crates/frankensearch-core):
- src/contract_sanity.rs — schema-version/redaction lockstep across
  components: every envelope producer and consumer must agree on schema
  versions, and redaction must be applied before any host boundary;
- src/observability_lint.rs — lint rules over evidence records/streams
  for CI gates (required fields, monotonic seq, no unredacted payloads).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

# The declared schema versions every component must agree on. Bump in one
# place; the sanity check fails if any runtime constant drifts.
EXPECTED_VERSIONS = {
    "telemetry": 1,
    "output_envelope": 1,
    "e2e_artifact": 1,
    "golden_profile": 1,
    "model_manifest": 1,
    "generation_manifest": 1,
    "flex_lexical": 1,
    "fleet_node": 1,
    "acquisition_receipt": 1,
    "footprint_advisor": 1,
}


@dataclass
class ContractReport:
    checked: int = 0
    violations: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


def check_schema_lockstep() -> ContractReport:
    """Import every schema constant and compare against the registry."""
    report = ContractReport()

    def check(name: str, actual: int) -> None:
        report.checked += 1
        expected = EXPECTED_VERSIONS[name]
        if actual != expected:
            report.violations.append(f"{name}: runtime v{actual} != registry v{expected}")

    from frankensearch_tpu_torch.cli.output import ENVELOPE_VERSION
    from frankensearch_tpu_torch.core.collectors import TELEMETRY_SCHEMA_VERSION
    from frankensearch_tpu_torch.core.e2e_artifact import E2E_SCHEMA_VERSION
    from frankensearch_tpu_torch.core.generation import MANIFEST_VERSION
    from frankensearch_tpu_torch.embed.model_download import RECEIPT_SCHEMA_VERSION
    from frankensearch_tpu_torch.embed.model_manifest import MANIFEST_SCHEMA_VERSION
    from frankensearch_tpu_torch.fleet.registry import NODE_SCHEMA_VERSION
    from frankensearch_tpu_torch.lexical.persist import FLEX_VERSION
    from frankensearch_tpu_torch.runtime.footprint import ADVISOR_VERSION
    from frankensearch_tpu_torch.utils.bench_regression import GOLDEN_SCHEMA_VERSION

    check("telemetry", TELEMETRY_SCHEMA_VERSION)
    check("output_envelope", ENVELOPE_VERSION)
    check("e2e_artifact", E2E_SCHEMA_VERSION)
    check("golden_profile", GOLDEN_SCHEMA_VERSION)
    check("model_manifest", MANIFEST_SCHEMA_VERSION)
    check("generation_manifest", MANIFEST_VERSION)
    check("flex_lexical", FLEX_VERSION)
    check("fleet_node", NODE_SCHEMA_VERSION)
    check("acquisition_receipt", RECEIPT_SCHEMA_VERSION)
    check("footprint_advisor", ADVISOR_VERSION)
    return report


# --- observability lint ------------------------------------------------------

_SENSITIVE_MARKERS = ("query", "content", "path", "text", "preview")


def lint_evidence_stream(records: Sequence[Mapping]) -> list[str]:
    """Lint rules over an evidence/telemetry record stream:
    R1 every record has a kind; R2 seq/at fields are monotonic when
    present; R3 no obviously-unredacted sensitive string fields
    (values must be 'redacted:*' for sensitive keys); R4 correlation ids
    present on telemetry events."""
    violations: list[str] = []
    last_seq = None
    last_at = None
    for i, r in enumerate(records):
        if "kind" not in r and "type" not in r:
            violations.append(f"R1 record {i}: missing kind/type")
        seq = r.get("seq")
        if seq is not None:
            if last_seq is not None and seq <= last_seq:
                violations.append(f"R2 record {i}: seq {seq} not increasing")
            last_seq = seq
        at = r.get("at") or r.get("emitted_at")
        if at is not None:
            if last_at is not None and at < last_at:
                violations.append(f"R2 record {i}: time went backwards")
            last_at = at
        payload = r.get("payload")
        if isinstance(payload, Mapping):
            for key, value in payload.items():
                if (
                    any(m in key.lower() for m in _SENSITIVE_MARKERS)
                    and isinstance(value, str)
                    and not value.startswith("redacted:")
                ):
                    violations.append(f"R3 record {i}: unredacted sensitive field {key!r}")
            if r.get("kind") and "correlation_id" not in r:
                violations.append(f"R4 record {i}: telemetry event without correlation_id")
    return violations
