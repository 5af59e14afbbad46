"""Training callbacks (counterpart of paddle_tpu/hapi/callbacks.py; ref:
python/paddle/hapi/callbacks.py — Callback, ProgBarLogger,
ModelCheckpoint, EarlyStopping, LRScheduler).  ``MetricsLogger``
publishes into the port's metrics registry (utils/monitor.py) and flight
recorder (utils/trace.py) under the JAX package's names."""
from __future__ import annotations

import time
from typing import List, Optional


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None, model=None,
                 params=None):
        self.callbacks = list(callbacks) if callbacks else []
        if params and params.get("verbose", 2) > 0:
            if not any(isinstance(c, ProgBarLogger) for c in self.callbacks):
                self.callbacks.insert(0, ProgBarLogger(
                    log_freq=params.get("log_freq", 10),
                    verbose=params.get("verbose", 2)))
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params or {})

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """ref: callbacks.py ProgBarLogger — per-epoch progress logging."""

    def __init__(self, log_freq=10, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        if self.verbose > 1 and step % self.log_freq == 0:
            items = " - ".join(f"{k}: {v:.4f}" for k, v in logs.items()
                               if isinstance(v, float))
            print(f"  step {step}{f'/{self.steps}' if self.steps else ''} - {items}")

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        if self.verbose:
            dur = time.time() - self._start
            items = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                for k, v in logs.items() if v is not None)
            print(f"  epoch {epoch + 1} done in {dur:.1f}s - {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(f"{self.save_dir}/final")


class EarlyStopping(Callback):
    """ref: callbacks.py EarlyStopping."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=False):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.verbose = verbose
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = None
        self.wait = 0

    def _better(self, value):
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        value = logs.get(self.monitor)
        if value is None:
            return
        if self._better(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping at epoch {epoch + 1}")


class MetricsLogger(Callback):
    """Publishes train-loop telemetry into the metrics registry
    (`utils.monitor`): `train.steps` / `train.epochs` counters, a
    `train.step_time_ms` histogram, and a `train.samples_per_sec` gauge
    computed from the `batch_size` fit parameter (or a `batch_size` entry
    in the step logs).  Collection obeys the `metrics` flag; pass a
    `MetricRegistry` to publish somewhere other than the process default."""

    def __init__(self, registry=None):
        super().__init__()
        from ..utils import monitor as _monitor

        reg = registry or _monitor.default_registry()
        self._steps = reg.counter(
            "train.steps", "Completed training steps (hapi Model.fit).")
        self._epochs = reg.counter(
            "train.epochs", "Completed training epochs (hapi Model.fit).")
        self._step_ms = reg.histogram(
            "train.step_time_ms", "Wall time per training step (ms).")
        self._sps = reg.gauge(
            "train.samples_per_sec", "Training throughput over the last "
            "step (needs batch_size in fit params or step logs).")
        self._t0 = None

    def on_train_begin(self, logs=None):
        self._t0 = None

    def on_train_batch_begin(self, step, logs=None):
        self._t0 = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        now = time.perf_counter()
        if self._t0 is None:
            # no batch_begin seen (custom loop): chain end-to-end instead
            self._t0 = now
            return
        dt = now - self._t0
        self._t0 = now
        self._steps.inc()
        self._step_ms.observe(dt * 1000.0)
        batch = (logs or {}).get("batch_size") or self.params.get("batch_size")
        if batch and dt > 0:
            self._sps.set(float(batch) / dt)
        from ..utils import trace as _trace

        _trace.flight_recorder().record(
            "train_step", name=f"step{step}", dur_ms=dt * 1000.0)

    def on_epoch_end(self, epoch, logs=None):
        self._epochs.inc()


class LRSchedulerCallback(Callback):
    """Steps an LRScheduler once per epoch (ref: callbacks.py LRScheduler)."""

    def __init__(self, by_step=False, by_epoch=True):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = self.model._optimizer
        from ..optimizer.lr import LRScheduler

        return opt._lr if opt and isinstance(opt._lr, LRScheduler) else None

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()
