"""The Layer system (counterpart of paddle_tpu/nn/layer/base.py; ref
python/paddle/fluid/dygraph/layers.py:675 ``Layer``, container.py).

``Layer`` is a ``torch.nn.Module`` with the JAX ``Layer``'s API on top;
``Parameter`` is a ``torch.nn.Parameter`` with the reference's fields.
Where the two APIs share a method name, the override keeps torch's
keywords working, so torch's own machinery (state-dict recursion,
``torch.func.functional_call``, ``Module.to`` with devices) still binds:

* ``state_dict(include_non_persistable_buffer)`` at the top level lists
  each tied parameter once, under its first name, parameters then
  buffers, as the JAX package does; torch's recursion into children
  (``destination=`` / ``prefix=`` / ``keep_vars=``) is torch's.
  ``load_state_dict`` fills a tied parameter's other names from its first.
* ``set_state_dict`` copies numpy arrays or tensors in place, shapes
  checked, and returns ``(missing, unexpected)``.
* ``to("bfloat16")`` reads a dtype name as a dtype (torch would read it as
  a device); devices and torch's other arguments pass through.
* ``named_parameters(prefix, include_sublayers)``, ``parameters``
  (a list) and ``named_buffers(prefix, persistable_only)`` take the
  reference's second argument positionally and torch's keywords.
* ``train()`` / ``eval()``, ``apply``, ``float()`` / ``bfloat16()`` and the
  forward pre-hooks are torch's (``register_forward_post_hook`` is
  ``register_forward_hook``); torch's ``apply`` visits children before
  the layer, the JAX package's the layer first.

Layers are built on the CPU (their initializers draw there, from a
generator); a model's ``device=`` or ``Layer.to(device)`` moves them.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ...core import dtype as _dtype


def _as_value(value, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A numpy array, a JAX array, a list or a tensor as a tensor (numpy's
    bfloat16 through float32); on ``like``'s device and dtype when given."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
    else:
        arr = np.asarray(value)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr))
    if like is not None:
        t = t.to(device=like.device, dtype=like.dtype)
    return t


def _assign(target: torch.Tensor, value, name: str) -> None:
    v = _as_value(value, like=target)
    if tuple(v.shape) != tuple(target.shape):
        raise ValueError(f"{name}: a value of shape {tuple(v.shape)} for a "
                         f"tensor of shape {tuple(target.shape)}")
    with torch.no_grad():
        target.copy_(v)


def _rebuild_parameter(data, trainable, name, initializer):
    return Parameter(data, trainable, name, initializer)


class Parameter(nn.Parameter):
    """A named, trainable tensor (ref framework.py:5135 ``ParamBase``):
    ``Parameter(value, trainable=True, name="", initializer=None)``.
    ``trainable`` is ``requires_grad`` (``stop_gradient`` its negation);
    ``initializer`` records what drew the value, so a cloned stack draws
    its copies anew from it.  ``requires_grad=`` is taken as torch's
    keyword for ``trainable``."""

    def __new__(cls, value=None, trainable=True, name="", initializer=None,
                *, requires_grad=None):
        if requires_grad is not None:
            trainable = requires_grad
        data = torch.empty(0) if value is None else _as_value(value)
        grad = bool(trainable) and (data.is_floating_point()
                                    or data.is_complex())
        p = super().__new__(cls, data, grad)
        p.__dict__["_param_name"] = name or ""
        p.__dict__["initializer"] = initializer
        # mesh dims splitting each dim (parallel.sharding reads it), or None
        p.__dict__["sharding_axes"] = None
        return p

    @property
    def name(self) -> str:
        return self.__dict__.get("_param_name", "")

    @name.setter
    def name(self, value):
        self.__dict__["_param_name"] = value

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    def set_value(self, value):
        """Copy ``value`` (numpy, list or tensor) in, in this parameter's
        dtype and device; the shape must match."""
        _assign(self, value, self.name or "Parameter.set_value")

    def numpy(self):
        t = self.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        result = type(self)(
            self.data.clone(memory_format=torch.preserve_format),
            self.requires_grad, self.name, self.initializer)
        result.sharding_axes = self.__dict__.get("sharding_axes")
        memo[id(self)] = result
        return result

    def __reduce_ex__(self, proto):
        return (_rebuild_parameter,
                (self.data, self.requires_grad, self.name, self.initializer))


def _dtype_spec(a) -> bool:
    if isinstance(a, np.dtype) or (isinstance(a, type)
                                   and issubclass(a, np.generic)):
        return True
    if isinstance(a, str):
        try:
            _dtype.exact_dtype(a)
            return True
        except ValueError:
            return False
    return False


class Layer(nn.Module):
    """Base class of every layer of the port (ref dygraph/layers.py:675);
    see the module docstring for how it meets ``torch.nn.Module``."""

    def __init__(self):
        super().__init__()

    # -- registration --------------------------------------------------------
    def add_parameter(self, name: str, parameter):
        """Register ``parameter`` (a value becomes a ``Parameter``) under
        ``name``; None registers nothing."""
        if parameter is not None and not isinstance(parameter, Parameter):
            parameter = Parameter(parameter, name=name)
        if parameter is not None:
            self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        *, persistent=None):
        """Non-trainable state (BN running statistics); in ``state_dict``
        when ``persistable`` (torch's ``persistent=`` is taken too)."""
        if persistent is not None:
            persistable = persistent
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = _as_value(tensor)
        super().register_buffer(name, tensor, persistent=persistable)

    def create_parameter(self, shape, dtype=None, default_initializer=None,
                         attr=None, is_bias: bool = False):
        """A new ``Parameter`` (not registered), drawn on the CPU from
        ``default_initializer`` (XavierUniform, or 0 for a bias); ``attr``
        gives its name, as in the JAX package."""
        from .. import initializer as init

        dtype = _dtype.exact_dtype(dtype) or _dtype.get_default_dtype()
        if default_initializer is None:
            default_initializer = (init.Constant(0.0) if is_bias
                                   else init.XavierUniform())
        name = getattr(attr, "name", None) or ""
        return Parameter(default_initializer(tuple(shape), dtype), True,
                         name, default_initializer)

    # -- traversal -----------------------------------------------------------
    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True, *, recurse=None,
                         remove_duplicate: bool = True):
        """(name, parameter) pairs, a tied parameter once under its first
        name."""
        if recurse is not None:
            include_sublayers = recurse
        return super().named_parameters(prefix=prefix,
                                        recurse=include_sublayers,
                                        remove_duplicate=remove_duplicate)

    def parameters(self, include_sublayers: bool = True, *,
                   recurse=None) -> List[nn.Parameter]:
        if recurse is not None:
            include_sublayers = recurse
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False):
        for name, layer in self.named_modules(prefix=prefix):
            if layer is self and not include_self:
                continue
            yield name, layer

    def sublayers(self, include_self: bool = False) -> List[nn.Module]:
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_buffers(self, prefix: str = "",
                      persistable_only: bool = False, *, recurse=True,
                      remove_duplicate: bool = True):
        if not persistable_only:
            yield from super().named_buffers(
                prefix=prefix, recurse=recurse,
                remove_duplicate=remove_duplicate)
            return
        mods = (self.named_modules(prefix=prefix) if recurse
                else [(prefix, self)])
        for mname, m in mods:
            for bname, b in m._buffers.items():
                if b is not None and bname not in m._non_persistent_buffers_set:
                    yield (f"{mname}.{bname}" if mname else bname), b

    def clear_gradients(self):
        """Drop the accumulated gradients (ref Layer.clear_gradients)."""
        for p in self.parameters():
            p.grad = None

    # -- state dict ----------------------------------------------------------
    def state_dict(self, include_non_persistable_buffer: bool = False, *,
                   destination=None, prefix: str = "", keep_vars=False):
        """{name: tensor}: the parameters (each tied one once, under its
        first name), then the persistable buffers (every buffer with
        ``include_non_persistable_buffer``).  Called with torch's
        ``destination`` / ``prefix`` (its recursion) it is torch's."""
        if destination is not None or prefix:
            return super().state_dict(destination=destination, prefix=prefix,
                                      keep_vars=keep_vars)
        out: Dict[str, Any] = collections.OrderedDict()
        for name, p in self.named_parameters():
            out[name] = p if keep_vars else p.detach()
        for name, b in self.named_buffers(
                persistable_only=not include_non_persistable_buffer):
            out[name] = b if keep_vars else b.detach()
        return out

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """torch's, after filling each tied parameter's other names from
        its first (which ``state_dict`` lists alone)."""
        state_dict = collections.OrderedDict(state_dict)
        first: Dict[int, str] = {}
        for name, p in self.named_parameters(remove_duplicate=False):
            head = first.setdefault(id(p), name)
            if name not in state_dict and head in state_dict:
                state_dict[name] = state_dict[head]
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy ``state_dict`` ({name: numpy array or tensor}, as the JAX
        package's ``state_dict()`` gives) into the parameters and buffers
        in place, in their dtypes and on their devices.  Returns
        ``(missing, unexpected)`` names."""
        del use_structured_name
        missing, unexpected = [], set(state_dict)
        for name, p in self.named_parameters():
            if name in state_dict:
                _assign(p, state_dict[name], name)
                unexpected.discard(name)
            else:
                missing.append(name)
        for mname, m in self.named_modules():
            for bname, b in list(m._buffers.items()):
                if b is None:
                    continue
                full = f"{mname}.{bname}" if mname else bname
                if full in state_dict:
                    v = _as_value(state_dict[full], like=b)
                    if v.shape == b.shape:
                        with torch.no_grad():
                            b.copy_(v)
                    else:
                        m._buffers[bname] = v
                    unexpected.discard(full)
                elif bname not in m._non_persistent_buffers_set:
                    missing.append(full)
        return missing, sorted(unexpected)

    load_dict = set_state_dict

    # -- dtype / device ------------------------------------------------------
    def to(self, *args, **kwargs):
        """torch's ``Module.to``, with a dtype name (``"bfloat16"``) or a
        numpy dtype read as a dtype."""
        args = [_dtype.exact_dtype(a) if _dtype_spec(a) else a for a in args]
        if kwargs.get("dtype") is not None:
            kwargs["dtype"] = _dtype.exact_dtype(kwargs["dtype"])
        return super().to(*args, **kwargs)

    # -- hooks ---------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)`` after each forward; a non-None
        return replaces the output."""
        return self.register_forward_hook(hook)


class LayerList(Layer, nn.ModuleList):
    """ref dygraph/container.py LayerList: sublayers "0", "1", ..."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.extend(sublayers)


class Sequential(Layer, nn.Sequential):
    """ref dygraph/container.py Sequential: ``Sequential(l1, l2, ...)`` or
    ``Sequential([(name, layer), ...])``."""

    def __init__(self, *layers):
        super().__init__()
        if (len(layers) == 1 and isinstance(layers[0], (list, tuple))
                and layers[0] and isinstance(layers[0][0], tuple)):
            for name, layer in layers[0]:
                self.add_module(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_module(str(i), layer)


class ParameterList(Layer, nn.ParameterList):
    """ref dygraph/container.py ParameterList: parameters "0", "1", ...;
    a value becomes a ``Parameter``."""

    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or ():
            self.append(p)

    def append(self, parameter):
        if not isinstance(parameter, Parameter):
            parameter = Parameter(parameter)
        return super().append(parameter)
