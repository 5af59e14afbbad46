"""Flags, dtypes and device resolution (counterpart of paddle_tpu.core)."""
