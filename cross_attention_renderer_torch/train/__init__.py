"""Full-image rendering loops."""
