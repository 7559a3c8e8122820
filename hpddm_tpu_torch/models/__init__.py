"""Test problems (host-side generators)."""
