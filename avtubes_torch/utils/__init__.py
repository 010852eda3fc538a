"""avtubes_torch.utils — import the sub-modules directly (nothing is imported eagerly)."""
