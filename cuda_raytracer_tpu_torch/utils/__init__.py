"""Utilities: timing, image I/O, logging."""
