"""avtubes_torch.models — import the sub-modules directly (nothing is imported eagerly)."""
