"""Model bundles, the loss, metrics, optimizer and the training loop."""
