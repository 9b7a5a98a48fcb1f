"""Figures of the reference's utils/plot.py (matplotlib imported lazily)."""
