"""Persistence/metadata layer over sqlite3.

Parity target: crates/frankensearch-storage (reference), which uses
FrankenSQLite; Python's stdlib sqlite3 plays the same role here.
"""
