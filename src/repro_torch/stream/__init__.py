"""Bounded-lookahead admission (the single-rank part serving uses)."""
