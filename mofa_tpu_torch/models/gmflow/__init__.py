"""The GMFlow / UniMatch optical-flow teacher (forward only)."""
