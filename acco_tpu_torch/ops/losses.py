"""Causal LM cross-entropy on materialized logits, with label smoothing.

Counterpart of ``acco_tpu/ops/losses.py``'s materialized path: next-token
shift, mean over targets that are not ``IGNORE_INDEX``, the log-sum-exp
in float32, and HF ``LabelSmoother`` smoothing
``(1 - eps) * nll + eps * mean_v(-log p_v)``.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def resolve_fused_loss(value, vocab_size: int) -> bool:
    """The ``fused_loss`` config key on one card: 'auto' keeps the
    materialized CE below a 100k vocab, as the JAX policy does for a
    single device; anything that would need the fused lm-head + CE kernel
    or the chunked form raises."""
    if value in (False, None, 0, "0", "false", "False", ""):
        return False
    if value == "auto" and vocab_size < 100_000:
        return False
    raise NotImplementedError(
        f"fused_loss={value!r} (vocab {vocab_size}) needs the fused lm-head + "
        "CE kernel or the chunked loss, not ported yet: ROADMAP.md queue 2 "
        "(K3) and queue 1, item 3"
    )


def causal_lm_loss(
    logits: torch.Tensor,  # [B, L, V]
    labels: torch.Tensor,  # [B, L] int, IGNORE_INDEX = masked
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Mean shifted cross-entropy, float32 scalar."""
    logits = logits[:, :-1, :].float()
    targets = labels[:, 1:].long()
    mask = (targets != IGNORE_INDEX).float()
    safe = torch.where(targets == IGNORE_INDEX, torch.zeros_like(targets), targets)
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    per_tok = logz - true_logit
    if label_smoothing:
        smooth = logz - logits.mean(dim=-1)
        per_tok = (1.0 - label_smoothing) * per_tok + label_smoothing * smooth
    return (per_tok * mask).sum() / mask.sum().clamp(min=1.0)
