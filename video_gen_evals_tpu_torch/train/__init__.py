"""Training of the fusion encoder: losses, the step, checkpoints, the experiment."""
