"""Timing and synthetic test data."""
