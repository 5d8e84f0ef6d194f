"""Logging and the ragged (variable-length) batch path."""
