"""Training: the train step, the trainer, and loading a trained run."""
