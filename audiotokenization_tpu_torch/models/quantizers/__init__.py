"""Quantizers: the factorized VQ and FSQ."""
