"""Parallel paths (``parallel/sp.py``: the anti-aliasing window helpers)."""
