"""Synthetic posed scenes."""
