"""Training engine: task, resident train step, trainer, paper harness."""
