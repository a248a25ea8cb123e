"""Checkpoint I/O for the static plane — the counterpart of
``paddle_tpu/framework_io.py``: ``save_state_dict`` / ``load_state_dict``,
``save_persistables`` / ``load_persistables`` and
``save_inference_model`` / ``load_inference_model``.

The format is the reference's: one numpy ``.npz`` for the tensors (the
reference's save_combine analog) and ``__model__.json`` for the pruned
Program and its feed and fetch names, so a model saved by either package
loads in the other. A loaded variable lands on the executor's device.
``save`` / ``load`` take the tape's Tensors and state dicts
(:mod:`~paddle_tpu_torch.dygraph`) as well.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch


def _to_numpy_dict(state: Dict) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in state.items():
        v = getattr(v, "value", v)      # a tape Tensor's torch tensor
        if isinstance(v, torch.Tensor):
            v = v.detach()
            out[k] = (v.float() if v.dtype == torch.bfloat16 else v) \
                .cpu().numpy()
        else:
            out[k] = np.asarray(v)
    return out


def save_state_dict(state: Dict, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_to_numpy_dict(state))
    # np.savez appends .npz; keep the exact path, as the reference does
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        os.replace(path + ".npz", path)


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def save(obj, path: str):
    """paddle.save: a dict of tape Tensors, tensors or arrays (a
    ``state_dict``), or one Tensor under the key ``"tensor"``, in the
    reference's npz format."""
    from .dygraph.tensor import Tensor
    if isinstance(obj, dict):
        save_state_dict(obj, path)
    elif isinstance(obj, Tensor):
        save_state_dict({"tensor": obj}, path)
    else:
        raise TypeError(f"cannot save {type(obj)}")


def load(path: str):
    """paddle.load: the saved dict, as numpy arrays (``Layer.
    set_state_dict`` copies them into its parameters)."""
    return load_state_dict(path)


# -- static-graph persistables (scope-based) --------------------------------

def save_persistables(executor, dirname: str, main_program=None,
                      scope=None, filename: Optional[str] = "params"):
    """Save every persistable variable of a program from the scope (the
    combined format)."""
    from .framework.program import default_main_program
    from .framework.scope import global_scope
    program = main_program or default_main_program()
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    payload = {}
    for v in program.list_vars():
        if v.persistable and scope.find_var(v.name) is not None:
            payload[v.name] = scope.get_numpy(v.name)
    save_state_dict(payload, os.path.join(dirname, filename or "params"))


def load_persistables(executor, dirname: str, main_program=None,
                      scope=None, filename: Optional[str] = "params"):
    """Load a program's persistable variables into the scope, on the
    executor's device; returns the names the file lacks."""
    from .framework.program import default_main_program
    from .framework.scope import global_scope
    program = main_program or default_main_program()
    scope = scope or global_scope()
    device = getattr(executor, "device", None)
    payload = load_state_dict(os.path.join(dirname, filename or "params"))
    missing = []
    for v in program.list_vars():
        if v.persistable:
            if v.name in payload:
                t = torch.from_numpy(np.array(payload[v.name]))
                scope.set_var(v.name, t if device is None else t.to(device))
            else:
                missing.append(v.name)
    return missing


def save_inference_model(dirname: str, feeded_var_names, target_vars,
                         executor, main_program=None, scope=None):
    """Prune to the inference slice and save the program JSON and its
    parameters (fluid/io.py save_inference_model)."""
    from .framework.program import Variable, default_main_program
    program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    inference = program.clone(for_test=True)._prune(
        target_vars, keep_var_names=feeded_var_names)
    meta = {
        "feed": list(feeded_var_names),
        "fetch": [v.name if isinstance(v, Variable) else str(v)
                  for v in target_vars],
    }
    with open(os.path.join(dirname, "__model__.json"), "w") as f:
        json.dump({"program": inference.to_dict(), "meta": meta}, f)
    save_persistables(executor, dirname, inference, scope)


def load_inference_model(dirname: str, executor, scope=None):
    """``(program, feed names, fetch names)`` of a saved inference
    model; its parameters are loaded into ``scope``."""
    from .framework.program import Program
    with open(os.path.join(dirname, "__model__.json")) as f:
        blob = json.load(f)
    program = Program.from_dict(blob["program"])
    load_persistables(executor, dirname, program, scope)
    return program, blob["meta"]["feed"], blob["meta"]["fetch"]
