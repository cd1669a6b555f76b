"""Launchers of the port: `serve` (batched LM generation, the VA service
and the serving frontend), `stream` (the VA fleet and its frontend) and
`train` (LM and VA training)."""
