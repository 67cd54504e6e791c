"""Entry points of the port (mirror mucon_tpu/cli)."""
