"""The per-frame SLAM front-end."""
