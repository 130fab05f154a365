"""Runtime pieces of the training loop: the dataloader."""
