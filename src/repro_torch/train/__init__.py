"""Training (port of `repro.train`): the single-device trainer, atomic
keep-k checkpoints, and the checkpoint-restart loop with its straggler
watchdog."""

from repro_torch.train import checkpoint, fault, trainer

__all__ = ["checkpoint", "fault", "trainer"]
