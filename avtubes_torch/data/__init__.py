"""avtubes_torch.data — import the sub-modules directly (nothing is imported eagerly)."""
