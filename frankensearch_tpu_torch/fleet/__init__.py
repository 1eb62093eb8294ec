"""Fleet operations console: discovery, telemetry materialization,
deterministic simulation.

Parity target: crates/frankensearch-ops (reference) — fleet discovery
(process/socket/heartbeat reconciliation), telemetry materialized into a
sqlite store, ``DataSource`` trait with a MockDataSource, and the
deterministic fleet simulator feeding integration/soak tests.
"""
