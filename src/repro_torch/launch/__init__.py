"""Launch layer: the serve driver's offline mode."""
