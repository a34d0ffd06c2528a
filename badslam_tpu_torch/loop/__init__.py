"""Loop closure and trajectory repair (host side)."""
