"""Preconditioners: overlapping Schwarz with GenEO coarse spaces, and
FETI/BDD substructuring (``substructure``)."""
