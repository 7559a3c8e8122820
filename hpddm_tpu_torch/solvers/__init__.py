"""Krylov solvers."""
