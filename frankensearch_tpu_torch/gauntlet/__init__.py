"""Differential conformance gauntlet + perf ratchet.

Parity target: crates/frankensearch-quill-gauntlet (reference) —
deterministic corpus/query generators, differential campaign runner
(candidate engine vs pinned oracle), metamorphic maintenance laws, and a
perf ratchet with A/A null controls. Here the oracle is the CPU
MemoryLexicalIndex (for BM25) and the plain f32 scan (for vector
kernels); the candidates are the port's device arms, on the card or, in
the tests, on the CPU.
"""
