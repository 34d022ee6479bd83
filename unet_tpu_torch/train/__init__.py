"""Model bundles (the training loop comes with a later slice)."""
