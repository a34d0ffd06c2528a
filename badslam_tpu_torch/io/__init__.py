"""Dataset input and trajectory output."""
