"""Frozen peaks and work counts."""
