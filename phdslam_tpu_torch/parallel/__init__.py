"""The island particle model (``parallel/island.py``), on one device."""
