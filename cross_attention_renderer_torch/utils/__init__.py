"""Image utilities."""
