"""avtubes_torch.train — import the sub-modules directly (nothing is imported eagerly)."""
