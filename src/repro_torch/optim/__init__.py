"""Local optimizers and schedules."""
