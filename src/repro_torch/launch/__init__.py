"""Launchers of the port: :mod:`~repro_torch.launch.serve` (batched LM
decode over the slot engine)."""
