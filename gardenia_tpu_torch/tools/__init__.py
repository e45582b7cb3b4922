"""Offline tools of the port (the converter)."""
