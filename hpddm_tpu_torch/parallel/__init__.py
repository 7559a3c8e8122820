"""Decomposition and the exchange layer."""
