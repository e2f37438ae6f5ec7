"""Causal LM cross-entropy: materialized, chunked, or through the fused kernel.

Counterpart of ``acco_tpu/ops/losses.py``:

- :func:`causal_lm_loss` on materialized logits: next-token shift (or
  pre-aligned labels with ``shift=False``), mean over targets that are not
  ``IGNORE_INDEX`` (or over ``num_valid``), the log-sum-exp in float32,
  HF ``LabelSmoother`` smoothing ``(1 - eps) * nll + eps * mean_v(-log
  p_v)``, and ``real_vocab`` exclusion of padded vocab columns;
- :func:`chunked_causal_lm_loss`: the same loss from the hidden states
  and the head, one sequence chunk's logits at a time, each recomputed in
  the backward (``torch.utils.checkpoint``), with no kernel of its own;
- :func:`vocab_parallel_causal_lm_loss`: the materialized CE over
  logits whose vocab dim is sharded over a tensor group (Megatron's
  vocab-parallel head under tensor parallelism);
- :func:`model_ce`: the dispatch between those and the fused lm-head + CE
  kernel (``ops/fused_ce.py``, K3, and its vocab-parallel wrapper), after
  :func:`resolve_fused_loss` has judged the ``fused_loss`` key against
  the model.

Under context parallelism (``seq_sharded``) the labels arrive
pre-shifted on the global sequence (``shift=False``) and the mean's
denominator is the global token count (``num_valid``); 'auto' resolves
to the fused kernel there, and 'chunk', which has no sequence-sharded
form, to the materialized CE. Under tensor parallelism (``vocab_group``,
a ``models.layers.TensorGroup``) the model's logits and head are its
shard's vocab slice: 'pallas' is K3's vocab-parallel wrapper, everything
else the materialized vocab-parallel CE ('chunk' has no sharded form).
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

IGNORE_INDEX = -100


def shift_labels(labels: torch.Tensor) -> torch.Tensor:
    """Next-token targets: ``out[:, t] = labels[:, t + 1]``, the last
    column IGNORE_INDEX. Context parallelism shifts on the global sequence
    before sharding, since a chunk's last target lives on the next rank."""
    return torch.cat([labels[..., 1:], torch.full_like(labels[..., :1], IGNORE_INDEX)], dim=-1)


def normalize_fused_loss(value) -> "bool | str":
    """Config spellings of ``fused_loss`` to False | 'auto' | 'chunk' |
    'pallas'. Legacy booleans mean the chunked form; 'pallas' is the fused
    kernel (the name the JAX package gave it); 'auto' defers to the policy
    in :func:`resolve_fused_loss`."""
    if value in (False, None, 0, "0", "false", "False", ""):
        return False
    if value in (True, 1, "1", "true", "True", "chunk"):
        return "chunk"
    if value in ("pallas", "auto"):
        return value
    raise ValueError(
        f"fused_loss must be False/True/'auto'/'chunk'/'pallas', got {value!r}"
    )


def _vocab(model) -> int:
    return getattr(model, "padded_vocab", None) or model.config.vocab_size


def _auto_fused_policy(model, platform: str, seq_sharded: bool = False,
                       n_vocab_shards: int = 1):
    """``fused_loss: 'auto'``, as the JAX policy decides on its accelerator:
    the kernel under a sharded vocab (tensor parallelism) and under context
    parallelism (the long-sequence regime is the no-logits loss's reason
    to exist) and for Llama-3-class vocabs (V >= 100k, where the [N, V]
    float32 logits dwarf the head's product), the materialized CE
    otherwise and everywhere on the CPU (the plain version is a test
    vehicle, not a performance path). Never 'chunk'."""
    if platform != "cuda":
        return False
    sharded = n_vocab_shards > 1 or seq_sharded
    return "pallas" if sharded or _vocab(model) >= 100_000 else False


def _platform_of(model) -> str:
    param = next(iter(model.parameters()), None) if hasattr(model, "parameters") else None
    return "cpu" if param is None else param.device.type


def resolve_fused_loss(fused_loss, model, real_vocab, warn=None,
                       n_vocab_shards: int = 1, seq_sharded: bool = False):
    """The fused-loss gate of the train path (``parallel/common.
    make_flat_loss_fn``): False | 'chunk' | 'pallas'.

    'pallas' outside the kernel's envelope (``ops/fused_ce.
    supports_fused_ce``, on the per-shard vocab under ``n_vocab_shards``)
    falls back to 'chunk', with a warning; 'chunk' under ``real_vocab``
    (Megatron padding, which it predates), a sharded vocab or context
    parallelism falls back to the materialized (vocab-parallel) CE. A model without ``hidden``/``lm_head`` takes
    the materialized CE. 'auto' resolves through the policy above; a
    policy pick outside the envelope resolves to False silently. ``warn``:
    optional callable taking a message, called on each downgrade of an
    explicit request. 'auto' reads the platform from the device of the
    model's parameters."""
    fused_loss = requested = normalize_fused_loss(fused_loss)
    if not fused_loss:
        return False
    if not (hasattr(model, "hidden") and hasattr(model, "lm_head")):
        if requested != "auto" and warn is not None:
            warn(
                f"fused_loss={requested!r}: model exposes no "
                "hidden/lm_head surface; using materialized logits"
            )
        return False
    if fused_loss == "auto":
        fused_loss = _auto_fused_policy(model, _platform_of(model), seq_sharded,
                                        n_vocab_shards)
        if not fused_loss:
            return False
    if fused_loss == "pallas":
        from acco_tpu_torch.ops.fused_ce import supports_fused_ce

        hidden, vocab = model.config.hidden_size, _vocab(model) // max(n_vocab_shards, 1)
        if not supports_fused_ce(8, hidden, vocab):
            if requested == "auto":
                return False
            if warn is not None:
                fallback = (
                    "'chunk'" if real_vocab is None and not seq_sharded and n_vocab_shards == 1
                    else "the materialized " + ("vocab-parallel " if n_vocab_shards > 1 else "")
                    + "CE"
                )
                warn(
                    f"fused_loss='pallas': hidden {hidden} / per-shard vocab "
                    f"{vocab} outside the kernel envelope; falling back to "
                    f"{fallback}"
                )
            fused_loss = "chunk"
    if fused_loss == "chunk" and (real_vocab is not None or seq_sharded or n_vocab_shards > 1):
        if warn is not None and requested == "chunk":
            form = ("sharded" if n_vocab_shards > 1 else "context-parallel" if seq_sharded
                    else "Megatron-padded")
            warn(f"fused_loss='chunk' has no {form} form; using the materialized "
                 + ("vocab-parallel " if n_vocab_shards > 1 else "") + "CE")
        return False
    return fused_loss


def real_vocab_of(model) -> int | None:
    """The unpadded vocab size when the model carries Megatron vocab
    padding (columns past it are excluded from the softmax), else None."""
    padded = getattr(model, "padded_vocab", None)
    if padded and padded != model.config.vocab_size:
        return model.config.vocab_size
    return None


def _per_token_ce(
    logits: torch.Tensor,  # [..., V] any float dtype
    targets: torch.Tensor,  # [...] int, IGNORE_INDEX = masked
    label_smoothing: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-token CE every materialized form shares (shift-free):
    float32 log-sum-exp, IGNORE_INDEX masking, HF smoothing. Returns
    ``(per_token_loss, valid_mask)``, float32."""
    logits = logits.float()
    targets = targets.long()
    mask = (targets != IGNORE_INDEX).float()
    safe = torch.where(targets == IGNORE_INDEX, torch.zeros_like(targets), targets)
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    per_tok = logz - true_logit
    if label_smoothing:
        smooth = logz - logits.mean(dim=-1)
        per_tok = (1.0 - label_smoothing) * per_tok + label_smoothing * smooth
    return per_tok, mask


def _mean(per_tok: torch.Tensor, mask: torch.Tensor, num_valid) -> torch.Tensor:
    denom = mask.sum() if num_valid is None else torch.as_tensor(
        num_valid, dtype=torch.float32, device=mask.device
    )
    return (per_tok * mask).sum() / denom.clamp(min=1.0)


def causal_lm_loss(
    logits: torch.Tensor,  # [B, L, V]
    labels: torch.Tensor,  # [B, L] int, IGNORE_INDEX = masked
    label_smoothing: float = 0.0,
    shift: bool = True,
    num_valid=None,
    vocab_group=None,
    real_vocab: int | None = None,
) -> torch.Tensor:
    """Mean (shifted) cross-entropy, float32 scalar. ``shift=False`` takes
    ``labels`` as already next-token aligned; ``num_valid`` replaces the
    mean's denominator; columns at or past ``real_vocab`` are left out of
    the softmax and the smoothing mean. ``vocab_group``: the logits are
    this shard's vocab slice (:func:`vocab_parallel_causal_lm_loss`)."""
    if vocab_group is not None:
        return vocab_parallel_causal_lm_loss(
            logits, labels, vocab_group, label_smoothing, shift=shift, num_valid=num_valid,
            real_vocab=real_vocab)
    if real_vocab is not None and real_vocab < logits.shape[-1]:
        logits = logits[..., :real_vocab]
    if shift:
        logits, labels = logits[:, :-1, :], labels[:, 1:]
    per_tok, mask = _per_token_ce(logits, labels, label_smoothing)
    return _mean(per_tok, mask, num_valid)


def vocab_parallel_causal_lm_loss(
    logits_local: torch.Tensor,  # [B, L, V/tp] this shard's vocab slice
    labels: torch.Tensor,  # [B, L] int GLOBAL ids, IGNORE_INDEX = masked
    vocab_group,  # models.layers.TensorGroup the vocab dim is sharded over
    label_smoothing: float = 0.0,
    shift: bool = True,
    num_valid=None,
    real_vocab: int | None = None,
) -> torch.Tensor:
    """:func:`causal_lm_loss` over vocab-sharded logits (JAX
    ``losses.py:261-300``): a float32 log-sum-exp over the local logits,
    stabilised by the ranks' max (no gradient), the exp-sums, the true
    logit and the logit sums summed over the group in one all-reduce
    (``layers.tp_all_reduce``, whose backward is the same sum),
    IGNORE_INDEX masking, HF smoothing. Columns whose global index is at
    or past ``real_vocab`` (Megatron padding) are left out of the softmax
    and the smoothing mean. Every rank returns the same full-vocab loss."""
    from acco_tpu_torch.models.layers import tp_all_reduce, tp_max

    if shift:
        logits_local, targets = logits_local[:, :-1, :], labels[:, 1:]
    else:
        targets = labels
    lg = logits_local.float()
    v_local = lg.shape[-1]
    v0 = vocab_group.rank * v_local
    vocab_total = v_local * vocab_group.size
    if real_vocab is not None and real_vocab < vocab_total:
        n_real_local = min(max(real_vocab - v0, 0), v_local)  # a host int per rank
        if n_real_local < v_local:
            col = torch.arange(v_local, device=lg.device)
            lg = torch.where(col < n_real_local, lg, torch.full((), -torch.inf, device=lg.device))
        vocab_total = real_vocab
    targets = targets.long()
    mask = (targets != IGNORE_INDEX).float()
    loc = torch.where(targets == IGNORE_INDEX, torch.zeros_like(targets), targets) - v0
    in_range = (loc >= 0) & (loc < v_local)
    picked = torch.gather(lg, -1, torch.where(in_range, loc, torch.zeros_like(loc))[..., None])
    picked = torch.where(in_range, picked[..., 0], torch.zeros((), device=lg.device))
    gmax = tp_max(lg.amax(dim=-1), vocab_group)
    parts = [torch.exp(lg - gmax[..., None]).sum(dim=-1), picked]
    if label_smoothing:
        parts.append(torch.where(torch.isfinite(lg), lg, torch.zeros((), device=lg.device))
                     .sum(dim=-1))
    summed = tp_all_reduce(torch.stack(parts), vocab_group)
    logz = torch.log(summed[0]) + gmax
    per_tok = logz - summed[1]
    if label_smoothing:
        per_tok = (1.0 - label_smoothing) * per_tok + label_smoothing * (
            logz - summed[2] / vocab_total)
    return _mean(per_tok, mask, num_valid)


def _chunk_terms(h, targets, lm_head, label_smoothing):
    from acco_tpu_torch.models.layers import lm_logits

    per_tok, mask = _per_token_ce(lm_logits(h, lm_head), targets, label_smoothing)
    return (per_tok * mask).sum(), mask.sum()


def chunked_causal_lm_loss(
    hidden: torch.Tensor,  # [B, L, D] final hidden states
    lm_head: torch.Tensor,  # [D, V] (wte transposed when tied)
    labels: torch.Tensor,  # [B, L] int, IGNORE_INDEX = masked
    label_smoothing: float = 0.0,
    n_chunks: int = 4,
) -> torch.Tensor:
    """``causal_lm_loss(hidden @ lm_head, labels)`` holding one sequence
    chunk's [B, L / n_chunks, V] float32 logits at a time: each chunk runs
    under ``torch.utils.checkpoint``, so its logits are recomputed in the
    backward rather than kept. The head product is ``layers.lm_logits``,
    as on the materialized path. The JAX form's ``scan`` is a Python loop
    here."""
    from torch.utils.checkpoint import checkpoint

    h_in, targets = hidden[:, :-1, :], labels[:, 1:]
    pad = (-h_in.shape[1]) % n_chunks
    if pad:
        h_in = F.pad(h_in, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=IGNORE_INDEX)
    lc = h_in.shape[1] // n_chunks
    total = valid = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        s, n = checkpoint(
            _chunk_terms, h_in[:, c * lc:(c + 1) * lc], targets[:, c * lc:(c + 1) * lc],
            lm_head, label_smoothing, use_reentrant=False, preserve_rng_state=False,
        )
        total, valid = total + s, valid + n
    return total / valid.clamp(min=1.0)


def model_ce(
    model,
    ids: torch.Tensor,
    attention_mask,
    labels: torch.Tensor,
    *,
    label_smoothing: float,
    fused,  # resolve_fused_loss's verdict: False | 'chunk' | 'pallas'
    vocab_group=None,
    real_vocab=None,
    num_valid=None,
    shift: bool = True,
) -> torch.Tensor:
    """The fused-vs-materialized CE dispatch of the train path, for a model
    that computes with the parameters it holds. ``fused`` must already
    have passed :func:`resolve_fused_loss`; ``vocab_group`` (the model's
    tensor group) selects the vocab-parallel forms."""
    if fused == "pallas":
        from acco_tpu_torch.ops.fused_ce import fused_ce_loss, vocab_parallel_fused_ce_loss

        h, head = model.hidden(ids, attention_mask), model.lm_head()
        if vocab_group is not None:
            return vocab_parallel_fused_ce_loss(
                h, head, labels, vocab_group, label_smoothing,
                shift=shift, num_valid=num_valid, real_vocab=real_vocab,
            )
        return fused_ce_loss(h, head, labels, label_smoothing,
                             shift=shift, num_valid=num_valid, real_vocab=real_vocab)
    if fused == "chunk":
        # the chunked form has no shift=False, num_valid, real_vocab or
        # sharded vocab; resolve_fused_loss never routes such a call here
        if not (shift is True and num_valid is None and real_vocab is None
                and vocab_group is None):
            raise ValueError(
                "fused_loss='chunk' supports only shift=True, num_valid=None, "
                f"real_vocab=None, vocab_group=None (got shift={shift!r}, "
                f"num_valid={'set' if num_valid is not None else None}, "
                f"real_vocab={real_vocab!r}, vocab_group="
                f"{'set' if vocab_group is not None else None}); use 'pallas' or the "
                "materialized path"
            )
        return chunked_causal_lm_loss(
            model.hidden(ids, attention_mask), model.lm_head(), labels, label_smoothing
        )
    return causal_lm_loss(
        model.apply(ids, attention_mask), labels, label_smoothing,
        shift=shift, num_valid=num_valid, vocab_group=vocab_group, real_vocab=real_vocab,
    )
