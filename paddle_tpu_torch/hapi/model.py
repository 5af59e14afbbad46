"""High-level ``Model`` API — prepare / fit / evaluate / predict
(counterpart of paddle_tpu/hapi/model.py).

Reference parity: python/paddle/hapi/model.py:788 (``Model``; fit :1243,
evaluate :1443, predict :1539) with its Static/DynamicGraphAdapter split.
The JAX package switches on ``core.tape.enabled()``: a jitted functional
step (parameters and optimizer state as explicit carries) with the tape
off, the eager step under ``dygraph.guard()``.  The port's tape is torch's
grad mode, on by default, so the port has one route, the eager one — the
reference's ``DynamicGraphAdapter``: ``loss.backward()``,
``opt.minimize(loss)``, ``network.clear_gradients()`` a batch (ROADMAP.md
Queue 3 records what a callback sees differently).

Host batches (numpy, from a ``DataLoader``) go to the network's device at
each step; with ``prefetch_to_device`` a ``DeviceFeeder`` thread stages
batch N+1 on the device while batch N computes (io/prefetch.py).  Step
logs materialize lazily (``_LazyLogs``): the loss is read to the host only
when a callback or the epoch summary reads it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import flags as _flags
from ..io import DataLoader, Dataset
from ..metric import Metric
from ..metric.metrics import _host
from ..nn.layer.base import Layer
from ..optimizer.optimizer import Optimizer
from . import callbacks as cb_mod


def _to_tuple(x):
    if x is None:
        return ()
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


def _to_device(b, dev: torch.device):
    """A batch's arrays (and tensors) as tensors on ``dev``, numpy dtypes
    kept; containers rebuilt."""
    if isinstance(b, dict):
        return {k: _to_device(v, dev) for k, v in b.items()}
    if isinstance(b, tuple):
        return tuple(_to_device(v, dev) for v in b)
    if isinstance(b, list):
        return [_to_device(v, dev) for v in b]
    if isinstance(b, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(b)).to(dev)
    if isinstance(b, torch.Tensor):
        return b.to(dev)
    return b


class _LazyLogs(dict):
    """Step logs whose values materialize on first read.

    Reading a loss on the card is a device sync that serializes dispatch.
    Values registered via :meth:`set_lazy` stay as pending thunks until a
    consumer (a callback, verbose logging, epoch summary) actually reads
    them — so ``fit(verbose=0)`` with no reading callbacks keeps the
    launch chain asynchronous."""

    def __init__(self, **eager):
        super().__init__(**eager)
        self._lazy = {}

    def set_lazy(self, key, thunk):
        super().pop(key, None)
        self._lazy[key] = thunk

    def _force(self, key):
        thunk = self._lazy.pop(key, None)
        if thunk is not None:
            super().__setitem__(key, thunk())

    def materialize(self) -> "_LazyLogs":
        for key in list(self._lazy):
            self._force(key)
        return self

    def __getitem__(self, key):
        self._force(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        self._force(key)
        return super().get(key, default)

    def __contains__(self, key):
        return key in self._lazy or super().__contains__(key)

    def __len__(self):
        return super().__len__() + len(self._lazy)

    def __iter__(self):
        self.materialize()
        return super().__iter__()

    def keys(self):
        self.materialize()
        return super().keys()

    def values(self):
        self.materialize()
        return super().values()

    def items(self):
        self.materialize()
        return super().items()

    def copy(self):
        return dict(self.materialize())


class Model:
    def __init__(self, network: Layer, inputs=None, labels=None):
        del inputs, labels  # static-graph InputSpec: no use on the eager route
        self.network = network
        self._optimizer: Optional[Optimizer] = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._amp = {}
        self.stop_training = False

    # -- setup ---------------------------------------------------------------
    def prepare(self, optimizer: Optional[Optimizer] = None, loss=None,
                metrics: Optional[Sequence[Metric]] = None, amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = list(metrics) if metrics else []
        self._amp = amp_configs or {}

    def _device(self) -> torch.device:
        for p in self.network.parameters():
            return p.device
        from ..core.device import resolve_device

        return resolve_device(None)

    # -- data plumbing -------------------------------------------------------
    @staticmethod
    def _split_batch(batch):
        """(x, y) convention: last element is the label, rest are inputs
        (matches hapi's inputs/labels split)."""
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2:
                return tuple(batch[:-1]), batch[-1]
            return (batch[0],), None
        return (batch,), None

    def _loader(self, data, batch_size, shuffle, num_workers, drop_last=False):
        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=drop_last)
        raise TypeError(f"expected Dataset or DataLoader, got {type(data)}")

    # -- training loop -------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            prefetch_to_device=False):
        """``prefetch_to_device=True`` (the network's device) or a device
        overlaps the host→device copy of batch N+1 with compute of batch N
        via a DeviceFeeder thread (io/prefetch.py), unless the loader
        already prefetches; step logs materialize lazily, so with
        ``verbose=0`` and no value-reading callbacks the loss stays on the
        device."""
        if self._optimizer is None:
            raise RuntimeError("call prepare(optimizer, loss) first")
        if (int(_flags.get_flag("elastic_save_every")) > 0
                and _flags.get_flag("elastic_ckpt_dir")):
            raise NotImplementedError(
                "fit's periodic elastic checkpoints (flags elastic_save_every"
                " / elastic_ckpt_dir) need the port of elastic/ (ROADMAP.md "
                "Queue 1 item 8c)")
        if _flags.get_flag("watchdog"):
            raise NotImplementedError(
                "fit's goodput watchdog (flags watchdog / "
                "watchdog_checkpoint_on_anomaly) needs the port of "
                "utils/watchdog.py (ROADMAP.md Queue 1 item 10) and its "
                "checkpoints elastic/ (item 8c)")
        loader = self._loader(train_data, batch_size, shuffle, num_workers,
                              drop_last=drop_last)
        prefetch = prefetch_to_device and not getattr(
            loader, "prefetch_to_device", False)
        cbs = cb_mod.CallbackList(callbacks, model=self,
                                  params={"epochs": epochs, "verbose": verbose,
                                          "steps": _safe_len(loader),
                                          "batch_size": batch_size,
                                          "log_freq": log_freq})
        cbs.on_train_begin()
        self.stop_training = False
        for epoch in range(epochs):
            cbs.on_epoch_begin(epoch)
            self.network.train()
            for m in self._metrics:
                m.reset()
            logs = {}
            batches = loader
            if prefetch:
                from ..io.prefetch import device_prefetch

                batches = device_prefetch(
                    loader, device=self._device() if prefetch_to_device is True
                    else prefetch_to_device)
            for step, batch in enumerate(batches):
                cbs.on_train_batch_begin(step)
                inputs, labels = self._split_batch(batch)
                loss, metric_outs = self._fit_step(inputs, labels)
                # lazy logs: float(loss) is a device sync — defer it until a
                # callback/verbose consumer actually reads the value
                logs = _LazyLogs(step=step)
                logs.set_lazy("loss", lambda l=loss: float(l))
                for m, mo in zip(self._metrics, metric_outs):
                    val = _metric_update(m, mo)
                    logs.set_lazy(
                        m.name(),
                        lambda v=val: (float(np.asarray(v).ravel()[0])
                                       if v is not None else None))
                cbs.on_train_batch_end(step, logs)
            epoch_logs = {"loss": logs.get("loss")}
            for m in self._metrics:
                epoch_logs[m.name()] = m.accumulate()
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_data, batch_size=batch_size,
                                          verbose=0, num_workers=num_workers)
                epoch_logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbs.on_epoch_end(epoch, epoch_logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/epoch_{epoch}")
            if self.stop_training:
                break
        cbs.on_train_end()
        return self

    def _fit_step(self, inputs, labels):
        """The eager step (ref DynamicGraphAdapter.train_batch,
        hapi/model.py:588): forward → loss.backward() → minimize →
        clear_gradients.  Returns the detached loss and each metric's
        ``compute`` on the step's outputs."""
        dev = self._device()
        inputs, labels = _to_device(inputs, dev), _to_device(labels, dev)
        opt = self._optimizer
        if opt._parameters is None:
            opt._parameters = self.network.parameters()
        outputs = _to_tuple(self.network(*_to_tuple(inputs)))
        loss = self._loss(*outputs, *_to_tuple(labels))
        loss.backward()
        opt.minimize(loss)
        self.network.clear_gradients()
        labels0 = labels[0] if isinstance(labels, (list, tuple)) else labels
        with torch.no_grad():
            metric_outs = tuple(m.compute(outputs[0].detach(), labels0)
                                for m in self._metrics)
        return loss.detach(), metric_outs

    @torch.no_grad()
    def _eval_step(self, inputs, labels):
        dev = self._device()
        inputs, labels = _to_device(inputs, dev), _to_device(labels, dev)
        outputs = _to_tuple(self.network(*_to_tuple(inputs)))
        loss = self._loss(*outputs, *_to_tuple(labels))
        labels0 = labels[0] if isinstance(labels, (list, tuple)) else labels
        return loss, tuple(m.compute(outputs[0], labels0)
                           for m in self._metrics)

    @torch.no_grad()
    def _pred_step(self, inputs):
        return self.network(*_to_tuple(_to_device(inputs, self._device())))

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        loader = self._loader(eval_data, batch_size, False, num_workers)
        self.network.eval()
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            inputs, labels = self._split_batch(batch)
            loss, metric_outs = self._eval_step(inputs, labels)
            # the losses stay on the device until the loop ends
            losses.append(loss)
            for m, mo in zip(self._metrics, metric_outs):
                _metric_update(m, mo)
        logs = {"loss": float(np.mean([_host(l) for l in losses]))
                if losses else 0.0}
        for m in self._metrics:
            logs[m.name()] = m.accumulate()
        self.network.train()
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=True,
                callbacks=None, verbose=1):
        loader = self._loader(test_data, batch_size, False, num_workers)
        self.network.eval()
        outs = []
        for batch in loader:
            inputs, _ = self._split_batch(batch) if isinstance(batch, (tuple, list)) \
                else ((batch,), None)
            # batch outputs stay on the device until the loop ends
            outs.append(_to_tuple(self._pred_step(inputs)))
        self.network.train()
        n_outputs = len(outs[0]) if outs else 0
        if stack_outputs and outs:
            return [np.concatenate([_host(b[i]) for b in outs], axis=0)
                    for i in range(n_outputs)]
        return [tuple(_host(o) for o in b) for b in outs]

    def train_batch(self, inputs, labels=None):
        loss, _ = self._fit_step(inputs, labels)
        return float(loss)

    def eval_batch(self, inputs, labels=None):
        loss, _ = self._eval_step(_to_tuple(inputs), labels)
        return float(loss)

    def predict_batch(self, inputs):
        out = self._pred_step(_to_tuple(inputs))
        if isinstance(out, torch.Tensor):
            return _host(out)
        return np.asarray([_host(o) for o in out])

    # -- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        from ..utils import checkpoint

        checkpoint.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            opt_state = self._optimizer._state
            if opt_state is not None:
                checkpoint.save({"opt": opt_state}, path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..utils import checkpoint

        state = checkpoint.load(path + ".pdparams")
        self.network.set_state_dict(state)
        if not reset_optimizer and self._optimizer is not None:
            try:
                opt = checkpoint.load(path + ".pdopt")
            except FileNotFoundError:
                return
            self._restore_optimizer(opt["opt"])

    def _restore_optimizer(self, saved):
        """Put a saved optimizer state ({"per_param": {i: slots}, "step":
        n}, numpy leaves) into the optimizer: in place where it already has
        a state, else as new tensors on the bound parameters' devices, as
        the JAX package's functional route resumes from ``_opt_state``."""
        opt = self._optimizer
        if opt._parameters is None:
            opt._parameters = self.network.parameters()
        params = opt._parameters

        def rebuild(cur, new, dev):
            if isinstance(new, (tuple, list)):
                cur = cur if cur is not None else [None] * len(new)
                return type(new)(rebuild(c, n, dev)
                                 for c, n in zip(cur, new))
            t = torch.from_numpy(np.array(new))
            if isinstance(cur, torch.Tensor):
                with torch.no_grad():
                    cur.copy_(t.to(cur.device, cur.dtype))
                return cur
            return t.to(dev)

        old = opt._state or {"per_param": {}}
        per = {k: rebuild(old["per_param"].get(k), v, params[int(k)].device)
               for k, v in saved["per_param"].items()}
        opt._state = {"per_param": per, "step": int(saved["step"])}
        opt._step_count = int(saved["step"])

    def parameters(self):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        lines = [repr(self.network)]
        total = sum(int(np.prod(p.shape)) for p in self.network.parameters())
        lines.append(f"Total params: {total:,}")
        s = "\n".join(lines)
        print(s)
        return {"total_params": total}


def _safe_len(loader):
    try:
        return len(loader)
    except TypeError:
        return None


def _metric_update(metric, compute_out):
    """Metrics whose compute() passes (pred, label) through take two update
    args (Precision/Recall/Auc); Accuracy-style metrics take the single
    compute result (ref hapi unpacks compute outputs the same way)."""
    if isinstance(compute_out, tuple):
        return metric.update(*compute_out)
    return metric.update(compute_out)
