"""Image and depth operations on torch tensors."""
