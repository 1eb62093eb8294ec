"""Terminal UI framework: screens, virtual clock, deterministic replay.

Parity target: crates/frankensearch-tui (reference) — AppShell +
ScreenRegistry (shell.rs), deterministic replay (replay.rs,
determinism.rs: TickClock virtual time + seeded RNG), JSONL evidence
hooks (evidence.rs). Rendering here is plain-text frames (no curses
dependency), which keeps PTY-free snapshot testing trivial.
"""
