"""Kernel entry points and their plain twins (mirror mucon_tpu/ops)."""
