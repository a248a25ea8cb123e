"""Linear-algebra op lowerings — the counterpart of
``paddle_tpu/ops/linalg_ops.py``: ``bmm``, ``cholesky``, ``inverse``,
``kron``, ``cross`` and ``trace``.

``cholesky`` and ``inverse`` go through cuSOLVER / cuBLAS on the card,
as the reference's CUDA kernels do (XLA's decompositions on the TPU).
``torch.linalg.cholesky`` and ``inv`` check the solver's ``info`` on the
host, which waits for the card; the ``_ex`` forms with
``check_errors=False`` do not, so a captured step can hold them. As in
the reference, ``cholesky`` factors the symmetrized input and a matrix
that is not positive definite gives NaN; a singular ``inverse`` gives
what the solver gives.
"""

from __future__ import annotations

import torch

from .registry import register


@register("bmm")
def _bmm(ctx, ins, attrs):
    """bmm_op.cc: batched (B, M, K) x (B, K, N)."""
    return {"Out": [torch.matmul(ins["X"][0], ins["Y"][0])]}


@register("cholesky")
def _cholesky(ctx, ins, attrs):
    """cholesky_op.cc: the lower factor (its transpose with ``upper``)."""
    x = ins["X"][0]
    x = (x + x.transpose(-1, -2)) / 2       # jnp.linalg.cholesky's rule
    low, info = torch.linalg.cholesky_ex(x, check_errors=False)
    # NaN through the product, so the gradient of a failed factor is NaN
    # too, as JAX's is; its upper triangle stays 0, as JAX's does
    bad = (info != 0).reshape(tuple(info.shape) + (1, 1))
    low = torch.tril(low * torch.where(bad, float("nan"), 1.0).to(low.dtype))
    if attrs.get("upper", False):
        low = low.transpose(-1, -2)
    return {"Out": [low]}


@register("inverse")
def _inverse(ctx, ins, attrs):
    """inverse_op.cc (getrf / getri batched)."""
    inv, _ = torch.linalg.inv_ex(ins["Input"][0], check_errors=False)
    return {"Output": [inv]}


@register("kron")
def _kron(ctx, ins, attrs):
    """kron_op.cc: the Kronecker product with batch broadcast, by shape
    interleaving (reshape, multiply, reshape)."""
    x, y = ins["X"][0], ins["Y"][0]
    nd = max(x.dim(), y.dim())
    x = x.reshape((1,) * (nd - x.dim()) + tuple(x.shape))
    y = y.reshape((1,) * (nd - y.dim()) + tuple(y.shape))
    xs, ys = [], []
    for d in range(nd):
        xs += [x.shape[d], 1]
        ys += [1, y.shape[d]]
    prod = x.reshape(xs) * y.reshape(ys)
    return {"Out": [prod.reshape(tuple(x.shape[d] * y.shape[d]
                                       for d in range(nd)))]}


@register("cross", no_grad_slots=())
def _cross(ctx, ins, attrs):
    """cross_op.cc: 3-vector cross products along ``dim`` (the default,
    9, is the first dim of size 3)."""
    x, y = ins["X"][0], ins["Y"][0]
    dim = attrs.get("dim", attrs.get("axis", 9))
    if dim == 9 or dim is None:
        dim = next(i for i, s in enumerate(x.shape) if s == 3)
    return {"Out": [torch.linalg.cross(x, y, dim=int(dim))]}


@register("trace")
def _trace(ctx, ins, attrs):
    """trace_op.cc: the sum of a diagonal at ``offset`` over (dim1,
    dim2)."""
    x = ins["Input"][0]
    diag = torch.diagonal(x, offset=int(attrs.get("offset", 0)),
                          dim1=int(attrs.get("dim1", attrs.get("axis1", 0))),
                          dim2=int(attrs.get("dim2", attrs.get("axis2", 1))))
    return {"Out": [diag.sum(-1)]}
