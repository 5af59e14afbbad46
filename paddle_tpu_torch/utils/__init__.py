"""Runtime utilities (counterpart of paddle_tpu.utils): the metrics
registry, the host profiler, tracing and the flight recorder, and
checkpoints."""
