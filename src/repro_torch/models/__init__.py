"""Models: the dense decoder-only transformer."""
