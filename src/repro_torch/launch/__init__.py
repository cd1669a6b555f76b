"""Launchers of the port: `serve` (batched LM generation, the VA service
and the serving frontend) and `stream` (the VA fleet and its frontend)."""
