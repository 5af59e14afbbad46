"""Entry point: the flagship eval-mode forward (counterpart of
``entry()`` in the JAX package's ``__graft_entry__.py``).

``entry()`` returns ``(fn, example_args)`` with ``fn(params, input_ids,
token_type_ids) -> (mlm_logits, nsp_logits)``: ERNIE-base (L12 H768 A12
I3072 V18000) in eval mode, its parameters bound functionally.
"""
from __future__ import annotations

from typing import Optional

import torch

from .convert import parameters_dict
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
