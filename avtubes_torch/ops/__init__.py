"""avtubes_torch.ops — import the sub-modules directly (nothing is imported eagerly)."""
