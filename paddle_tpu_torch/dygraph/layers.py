"""Layer — the tape's module base class, the counterpart of
``paddle_tpu/dygraph/layers.py``: parameter and sublayer registration by
attribute assignment, train/eval mode, state dicts, forward hooks, and
the containers ``Sequential``, ``LayerList`` and ``ParameterList``.

Parameters are drawn with the reference's initializers from the numpy
``RandomState`` that :func:`seed` sets (``initializer.eager_init``), so a
seeded layer's parameters equal the reference's bit for bit, and made
on the layer's ``device`` (keyword-only; None is the card, resolved at
the first parameter, so a container never needs one).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..device import resolve_device
from ..framework import unique_name
from ..initializer import (ConstantInitializer, Initializer,
                           XavierInitializer, eager_init)
from ..param_attr import ParamAttr
from .tensor import Parameter, Tensor

_global_seed_state = {"rng": np.random.RandomState()}


def seed(value: int):
    """paddle.seed analog — seeds dygraph param init + eager random ops."""
    _global_seed_state["rng"] = np.random.RandomState(value)
    from ..ops import registry
    registry._EAGER_SEED = int(value)
    return _global_seed_state["rng"]


def _rng() -> np.random.RandomState:
    return _global_seed_state["rng"]


class Layer:
    def __init__(self, name_scope: Optional[str] = None, dtype="float32", *,
                 device=None):
        self.training = True
        self._dtype = dtype
        self._device = device
        self._parameters: "OrderedDict[str, Parameter]" = OrderedDict()
        self._sub_layers: "OrderedDict[str, Layer]" = OrderedDict()
        self._buffers: "OrderedDict[str, Tensor]" = OrderedDict()
        self._forward_pre_hooks = OrderedDict()
        self._forward_post_hooks = OrderedDict()
        self._full_name = unique_name.generate(
            name_scope or type(self).__name__.lower())

    # -- parameter creation ------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None,
                         is_bias: bool = False,
                         default_initializer: Optional[Initializer] = None
                         ) -> Optional[Parameter]:
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        self._device = resolve_device(self._device)
        init = attr.initializer or default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()
        value = eager_init(init, shape, dtype or self._dtype, _rng())
        name = attr.name or unique_name.generate(f"{self._full_name}.w")
        p = Parameter(value, name=name, trainable=attr.trainable,
                      device=self._device)
        p.regularizer = attr.regularizer
        p.lr_scale = attr.learning_rate
        return p

    def register_buffer(self, name: str, tensor: Tensor,
                        persistable: bool = True):
        tensor.persistable = persistable
        self._buffers[name] = tensor
        object.__setattr__(self, name, tensor)

    def add_sublayer(self, name: str, sublayer: "Layer") -> "Layer":
        self._sub_layers[name] = sublayer
        object.__setattr__(self, name, sublayer)
        return sublayer

    def add_parameter(self, name: str, parameter: Optional[Parameter]):
        if parameter is not None:
            self._parameters[name] = parameter
        object.__setattr__(self, name, parameter)
        return parameter

    # -- attribute magic ---------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.setdefault("_parameters", OrderedDict())
        subs = self.__dict__.setdefault("_sub_layers", OrderedDict())
        # rebinding to a different kind removes the stale registration
        params.pop(name, None)
        subs.pop(name, None)
        if isinstance(value, Parameter):
            params[name] = value
        elif isinstance(value, Layer):
            subs[name] = value
        object.__setattr__(self, name, value)

    # -- traversal ---------------------------------------------------------
    def parameters(self, include_sublayers: bool = True) -> List[Parameter]:
        if not include_sublayers:
            return list(self._parameters.values())
        return [p for _, p in self.named_parameters()]

    def named_parameters(self, prefix: str = "") -> Iterator[
            Tuple[str, Parameter]]:
        seen = set()
        for name, p in self._parameters.items():
            if id(p) not in seen:
                seen.add(id(p))
                yield (f"{prefix}.{name}" if prefix else name), p
        for lname, sub in self._sub_layers.items():
            sp = f"{prefix}.{lname}" if prefix else lname
            for item in sub.named_parameters(sp):
                if id(item[1]) not in seen:
                    seen.add(id(item[1]))
                    yield item

    def sublayers(self, include_self: bool = False) -> List["Layer"]:
        out = [self] if include_self else []
        for sub in self._sub_layers.values():
            out.append(sub)
            out.extend(sub.sublayers())
        return out

    def named_sublayers(self, prefix: str = "", include_self: bool = False):
        if include_self:
            yield prefix, self
        for name, sub in self._sub_layers.items():
            sp = f"{prefix}.{name}" if prefix else name
            yield from sub.named_sublayers(sp, include_self=True)

    def children(self):
        return iter(self._sub_layers.values())

    def named_children(self):
        return iter(self._sub_layers.items())

    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # -- modes -------------------------------------------------------------
    def train(self):
        for layer in self.sublayers(include_self=True):
            layer.training = True
        return self

    def eval(self):
        for layer in self.sublayers(include_self=True):
            layer.training = False
        return self

    # -- state dict --------------------------------------------------------
    def state_dict(self, prefix: str = "") -> "OrderedDict[str, Tensor]":
        out = OrderedDict()
        for name, p in self._parameters.items():
            out[f"{prefix}.{name}" if prefix else name] = p
        for name, b in self._buffers.items():
            if b.persistable:
                out[f"{prefix}.{name}" if prefix else name] = b
        for lname, sub in self._sub_layers.items():
            sp = f"{prefix}.{lname}" if prefix else lname
            out.update(sub.state_dict(sp))
        return out

    def set_state_dict(self, state: Dict, use_structured_name: bool = True):
        """Copy ``state``'s values (Tensors, torch tensors or arrays) into
        the held tensors, in place; returns the keys ``state`` lacks."""
        own = self.state_dict()
        missing = []
        for k, v in own.items():
            if k in state:
                v.set_value(state[k])
            else:
                missing.append(k)
        return missing

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- hooks -------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        handle = len(self._forward_post_hooks)
        self._forward_post_hooks[handle] = hook
        return handle

    def register_forward_pre_hook(self, hook):
        handle = len(self._forward_pre_hooks)
        self._forward_pre_hooks[handle] = hook
        return handle

    # -- call --------------------------------------------------------------
    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        for hook in self._forward_pre_hooks.values():
            r = hook(self, args)
            if r is not None:
                args = r if isinstance(r, tuple) else (r,)
        out = self.forward(*args, **kwargs)
        for hook in self._forward_post_hooks.values():
            r = hook(self, args, out)
            if r is not None:
                out = r
        return out

    def full_name(self):
        return self._full_name

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], tuple):
            for name, layer in layers[0]:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._sub_layers.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        return list(self._sub_layers.values())[idx]

    def __len__(self):
        return len(self._sub_layers)


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or []):
            self.add_sublayer(str(i), layer)

    def append(self, layer):
        self.add_sublayer(str(len(self._sub_layers)), layer)
        return self

    def __getitem__(self, idx):
        return list(self._sub_layers.values())[idx]

    def __iter__(self):
        return iter(self._sub_layers.values())

    def __len__(self):
        return len(self._sub_layers)


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or []):
            self.add_parameter(str(i), p)

    def append(self, p):
        self.add_parameter(str(len(self._parameters)), p)
        return self

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __iter__(self):
        return iter(self._parameters.values())

    def __len__(self):
        return len(self._parameters)
