"""Training: the LR schedule, the trainer loop and npz checkpoints."""
