"""Device mesh and process-group set-up (core/mesh.py)."""
