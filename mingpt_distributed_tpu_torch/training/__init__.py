"""Training: optimizer, train/eval steps, trainer loop, snapshots, metrics."""
