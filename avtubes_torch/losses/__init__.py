"""avtubes_torch.losses — import the sub-modules directly (nothing is imported eagerly)."""
