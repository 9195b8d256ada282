"""Training: losses, learning-rate schedules, phases and the trainer."""
