"""avtubes_torch.evaluation — import the sub-modules directly (nothing is imported eagerly)."""
