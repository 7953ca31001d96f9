"""The renderer and its light-field decoder."""
