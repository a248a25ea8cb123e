"""CTR-stack op lowerings — the counterpart of ``paddle_tpu/ops/ctr_ops.py``:
``cvm``, ``data_norm``, ``nce`` and ``sample_logits``.

``nce`` and ``sample_logits`` draw their negatives from the op's key with
JAX's streams (:mod:`~paddle_tpu_torch.prng`): a uniform for the
log-uniform sampler, ``jax.random.randint`` for the uniform one and
``jax.random.categorical``'s Gumbel-max for a custom distribution.
"""

from __future__ import annotations

import math

import torch

from .. import prng
from .registry import register


@register("cvm", no_grad_slots=("CVM",))
def _cvm(ctx, ins, attrs):
    """Show / click (the first two columns) log-transformed (use_cvm) or
    stripped."""
    x = ins["X"][0]
    if bool(attrs.get("use_cvm", True)):
        show = torch.log(x[:, 0:1] + 1.0)
        click = torch.log(x[:, 1:2] + 1.0) - show
        return {"Y": [torch.cat([show, click, x[:, 2:]], dim=1)]}
    return {"Y": [x[:, 2:]]}


@register("data_norm",
          no_grad_slots=("BatchSize", "BatchSum", "BatchSquareSum",
                         "scale_w", "bias"))
def _data_norm(ctx, ins, attrs):
    """Normalization by accumulated batch statistics: means = sum / size,
    scales = sqrt(size / square_sum); with ``slot_dim`` a slot whose
    leading (show) value is 0 gives zeros."""
    x = ins["X"][0]
    bsize = ins["BatchSize"][0].reshape(-1)
    bsum = ins["BatchSum"][0].reshape(-1)
    bsq = ins["BatchSquareSum"][0].reshape(-1)
    slot_dim = int(attrs.get("slot_dim", -1))
    means = bsum / bsize
    scales = torch.sqrt(bsize / bsq)
    y = (x - means[None, :]) * scales[None, :]
    if slot_dim > 0:
        n, d = x.shape
        show = x.reshape(n, d // slot_dim, slot_dim)[:, :, 0:1]
        live = (torch.abs(show) >= 1e-7).to(x.dtype)
        y = (y.reshape(n, d // slot_dim, slot_dim) * live).reshape(n, d)
    return {"Y": [y], "Means": [means], "Scales": [scales]}


def _log_uniform_prob(labels, num_total):
    k = labels.to(torch.float32)
    return torch.log((k + 2.0) / (k + 1.0)) / math.log(float(num_total) + 1.0)


def _noise_prob(sampler, labels, num_total, probs):
    if sampler == 1:
        return _log_uniform_prob(labels, num_total)
    if sampler == 2 and probs is not None:
        return probs[labels]
    return torch.full(labels.shape, 1.0 / num_total, dtype=torch.float32,
                      device=labels.device)


def _log_uniform(key, shape, num_total, device):
    """The log-uniform sampler: ``exp(u * log(range + 1)) - 1``."""
    u = prng.uniform(key, shape).to(device)
    neg = torch.exp(u * math.log(float(num_total) + 1.0)) - 1.0
    return torch.clamp(neg.to(torch.int64), 0, num_total - 1)


@register("nce", no_grad_slots=("Label", "SampleWeight", "CustomDistProbs",
                                "CustomDistAlias", "CustomDistAliasProbs"))
def _nce(ctx, ins, attrs):
    """Noise-contrastive estimation: cost = sum over the true classes of
    -log(o / (o + b)) plus over the negatives of -log(b / (o + b)), with
    o = exp(logit) and b = P_noise * num_neg_samples."""
    x = ins["Input"][0]                      # (N, D)
    label = ins["Label"][0]                  # (N, num_true)
    weight = ins["Weight"][0]                # (C, D)
    bias = ins.get("Bias", [None])[0]        # (C,)
    sample_weight = ins.get("SampleWeight", [None])[0]
    probs = ins.get("CustomDistProbs", [None])[0]
    num_total = int(attrs["num_total_classes"])
    num_neg = int(attrs.get("num_neg_samples", 10))
    sampler = int(attrs.get("sampler", 0))
    n = x.shape[0]
    label = label.reshape(n, -1).to(torch.int64)
    num_true = label.shape[1]
    key = ctx.rng()
    if sampler == 1:
        neg = _log_uniform(key, (n, num_neg), num_total, x.device)
    elif sampler == 2 and probs is not None:
        logp = torch.log(torch.clamp_min(probs, 1e-20))
        g = prng.gumbel(key, (n, num_neg, probs.shape[-1])).to(x.device)
        neg = torch.argmax(g + logp, dim=-1)
    else:
        neg = prng.randint(key, (n, num_neg), 0, num_total).to(x.device)
    samples = torch.cat([label, neg], dim=1)              # (N, T+S)
    logit = torch.einsum("nd,nsd->ns", x, weight[samples])
    if bias is not None:
        logit = logit + bias.reshape(-1)[samples]
    o = torch.exp(logit)
    b = (_noise_prob(sampler, samples, num_total, probs) * num_neg).to(o.dtype)
    is_true = (torch.arange(samples.shape[1], device=x.device)
               < num_true)[None, :]
    cost = torch.where(is_true, -torch.log(o / (o + b)),
                       -torch.log(b / (o + b)))
    if sample_weight is not None:
        cost = cost * sample_weight.reshape(n, 1).to(cost.dtype)
    return {"Cost": [cost.sum(1, keepdim=True)], "SampleLogits": [logit],
            "SampleLabels": [samples]}


@register("sample_logits",
          no_grad_slots=("Labels", "CustomizedSamples",
                         "CustomizedProbabilities"))
def _sample_logits(ctx, ins, attrs):
    """Sampled softmax: the logits at [true, sampled] classes minus
    log(q), accidental hits pushed down, labels remapped to the sample
    space."""
    logits = ins["Logits"][0]                        # (N, C)
    labels = ins["Labels"][0].to(torch.int64)        # (N, T)
    num_samples = int(attrs.get("num_samples", 10))
    n, c = logits.shape
    num_true = labels.shape[1]
    if ins.get("CustomizedSamples", [None])[0] is not None:
        samples = ins["CustomizedSamples"][0].to(torch.int64)
        probabilities = ins["CustomizedProbabilities"][0]
    else:
        neg = _log_uniform(ctx.rng(), (n, num_samples), c, logits.device)
        samples = torch.cat([labels, neg], dim=1)
        probabilities = _log_uniform_prob(samples, c)
    picked = torch.gather(logits, 1, samples)
    sampled = picked - torch.log(
        torch.clamp_min(probabilities, 1e-20)).to(picked.dtype)
    if bool(attrs.get("remove_accidental_hits", True)):
        hit = (samples[:, None, :] == labels[:, :, None]).any(dim=1)
        hit = hit & (torch.arange(samples.shape[1], device=logits.device)
                     >= num_true)[None, :]
        sampled = torch.where(hit, sampled - 1e20, sampled)
    sampled_label = torch.arange(num_true, dtype=torch.int64,
                                 device=logits.device)[None, :].expand(
                                     n, num_true)
    return {"SampledLogits": [sampled], "Samples": [samples],
            "Probabilities": [probabilities],
            "SampledLabels": [sampled_label]}
