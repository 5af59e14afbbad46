"""Runtime utilities (counterpart of paddle_tpu.utils): the metrics
registry only, for now."""
