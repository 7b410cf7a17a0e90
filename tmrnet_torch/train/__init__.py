"""Training: losses, optimizers, the train state and steps, the epoch
loops of both stages and the LFB build."""
