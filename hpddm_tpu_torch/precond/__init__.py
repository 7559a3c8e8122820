"""Preconditioners: overlapping Schwarz with GenEO coarse spaces."""
