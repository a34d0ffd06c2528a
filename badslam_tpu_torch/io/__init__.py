"""Dataset input, trajectory and point-cloud output."""
