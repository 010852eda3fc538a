"""avtubes_torch.tools — the serving and data tools; import the sub-modules directly."""
