"""Cross-cutting utilities of the port: stage timing, console logging and the jsonl metrics log."""
