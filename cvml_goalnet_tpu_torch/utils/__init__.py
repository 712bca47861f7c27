"""Cross-cutting utilities of the port: stage timing."""
