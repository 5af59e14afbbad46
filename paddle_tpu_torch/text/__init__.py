"""Text models of the port (counterpart of paddle_tpu.text)."""
