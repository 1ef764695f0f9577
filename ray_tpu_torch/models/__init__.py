"""Models of the port (see ray_tpu/models)."""
