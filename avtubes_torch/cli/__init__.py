"""avtubes_torch.cli — import the sub-modules directly (nothing is imported eagerly)."""
