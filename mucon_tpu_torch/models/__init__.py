"""Model modules of the port (mirror mucon_tpu/models)."""
