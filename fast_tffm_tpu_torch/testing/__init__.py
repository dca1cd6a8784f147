"""Deterministic fault injection for the port's tests and smoke run."""
