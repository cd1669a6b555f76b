"""Launchers of the port: `serve` (batched LM generation, VA service)."""
