"""Host-side utilities of the port (counterpart of rmnet_tpu/utils)."""
