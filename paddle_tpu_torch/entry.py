"""Entry points (counterpart of the JAX package's ``__graft_entry__.py``).

* ``entry()`` returns ``(fn, example_args)`` with ``fn(params, input_ids,
  token_type_ids) -> (mlm_logits, nsp_logits)``: ERNIE-base (L12 H768 A12
  I3072 V18000) in eval mode, its parameters bound functionally.
* ``make_train_step(model, criterion, optimizer, compute_dtype)`` builds
  the pretraining step that ``bench.py`` runs: forward in
  ``compute_dtype`` over fp32 master parameters, MLM + NSP loss, backward,
  optimizer update.  Recompute comes with the model
  (``ErnieConfig(enable_recompute=..., recompute_policy=...)``); the
  optimizer is any of ``paddle_tpu_torch.optimizer``'s, its gradient clip,
  weight decay and LR schedule applied inside ``update``, or fleet's
  ``DistributedOptimizer``; a ``parallel.DataParallel`` model averages
  each step's gradients over the data-parallel ranks before the update.
"""
from __future__ import annotations

from typing import Optional

import torch

from .convert import parameters_dict
from .core import random as _random
from .core.device import resolve_device
from .text.ernie import ErnieConfig, ErnieForPretraining


def entry(device=None, dtype: torch.dtype = torch.float32,
          generator: Optional[torch.Generator] = None,
          config: Optional[ErnieConfig] = None):
    """Return ``(fn, example_args)`` for the ERNIE-base eval forward on
    ``device`` (default CUDA; raises when there is none)."""
    dev = resolve_device(device)
    model = ErnieForPretraining(config or ErnieConfig(), device=dev,
                                generator=generator)
    model.eval()
    if dtype != torch.float32:
        model.to(dtype)
    params = parameters_dict(model)

    def forward(params, input_ids, token_type_ids):
        with torch.inference_mode():
            return torch.func.functional_call(model, params,
                                              (input_ids, token_type_ids))

    batch, seq = 2, 128
    input_ids = torch.ones((batch, seq), dtype=torch.int64, device=dev)
    token_type_ids = torch.zeros((batch, seq), dtype=torch.int64, device=dev)
    return forward, (params, input_ids, token_type_ids)


def make_train_step(model, criterion, optimizer,
                    compute_dtype: torch.dtype = torch.float32):
    """Build ``train_step(params, opt_state, batch, generator) -> (params,
    opt_state, loss)`` (counterpart of ``make_train_step`` in the JAX
    package's ``__graft_entry__.py``).

    ``params`` is the {name: tensor} dict of ``convert.parameters_dict``
    (the fp32 masters; the tied word embedding appears once).  Inside the
    loss, floating parameters are cast to ``compute_dtype`` and bound with
    ``torch.func.functional_call``, which ties the MLM decoder to the same
    cast embedding, so its gradient sums both uses.  ``batch`` holds
    ``input_ids``, ``token_type_ids``, ``mlm_labels``, ``nsp_labels`` and
    optionally ``masked_positions`` (fed to the model, so only the masked
    tokens reach the vocabulary decoder).  Logits go to fp32 before the
    criterion.  Dropout draws from ``generator``, a CPU ``torch.Generator``
    opened as the active one (``core.random.rng_scope``); under recompute
    the backward's replay draws the forward's seeds again
    (``autograd.recompute``).  Gradients with
    respect to the masters come from ``torch.autograd.grad``; then
    ``optimizer.update`` applies them (in place for the port's
    optimizers).  When ``model`` is a ``parallel.DataParallel``, the step
    runs its wrapped layer and passes the gradients through
    ``model.apply_collective_grads`` before the update.  ``loss`` is a
    detached fp32 scalar tensor (this rank's).
    """
    sync = None
    if getattr(model, "apply_collective_grads", None) is not None:
        sync, model = model.apply_collective_grads, model._layers

    def loss_fn(params, batch):
        if compute_dtype != torch.float32:
            params = {k: v.to(compute_dtype) if v.is_floating_point() else v
                      for k, v in params.items()}
        kwargs = {}
        if batch.get("masked_positions") is not None:
            kwargs["masked_positions"] = batch["masked_positions"]
        logits, nsp = torch.func.functional_call(
            model, params, (batch["input_ids"], batch["token_type_ids"]),
            kwargs)
        return criterion(logits.float(), nsp.float(), batch["mlm_labels"],
                         batch["nsp_labels"])

    def train_step(params, opt_state, batch, generator: torch.Generator):
        names = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        with _random.rng_scope(generator):
            loss = loss_fn(leaves, batch)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        if sync is not None:
            grads = sync(grads)
        new_params, new_state = optimizer.update(grads, opt_state, params)
        return new_params, new_state, loss.detach()

    return train_step
