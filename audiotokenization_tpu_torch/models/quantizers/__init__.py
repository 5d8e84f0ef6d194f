"""Quantizers: the factorized VQ."""
