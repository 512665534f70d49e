"""The least work of a training step, a file a model family."""
