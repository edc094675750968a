"""Element tables (host NumPy)."""
