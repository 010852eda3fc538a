"""avtubes_torch.core — import the sub-modules directly (nothing is imported eagerly)."""
