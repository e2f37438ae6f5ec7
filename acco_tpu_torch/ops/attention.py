"""Plain multi-head attention, its mask, and the impl resolver.

Counterpart of ``acco_tpu/ops/attention.py`` for the training path:

- :func:`dot_product_attention` scores in float32, adds an additive
  float32 bias whose masked value is -1e9 (not -inf), runs the softmax in
  float32 and casts the probabilities to the activation dtype before the
  PV product — the JAX einsum path's numerics.
  The probabilities' cast goes through the ``attn_probs`` op, so that
  ``remat='dots+probs'`` (``models/layers.wrap_remat``) can save them, as
  JAX names them ``attn_probs``.
- :func:`resolve_attention_impl` maps the config's
  ``use_pallas_attention`` onto 'xla' (this module's plain path), 'fused'
  (K1, ops/fused_attention.py) or 'flash' (K5, ops/flash_attention.py,
  the Hopper kernel of JAX's bundled TPU flash kernel). On CUDA, 'auto'
  takes JAX's TPU threshold for flash (acco_tpu/ops/attention.py:126):
  'flash' from L 2048 without remat and from L 4096 with it, L a
  multiple of 512, where K5 takes the head dim; below that 'fused' where
  K1 takes the shape, else 'xla' (the port's own choice below the
  threshold: JAX's TPU policy takes 'xla' for L past 1024 there). On the
  CPU 'auto' is the plain path, as the JAX resolver is off the TPU;
  'fused' and 'flash' on the CPU run their kernels' plain versions.
  'ring' (context parallelism, ops/ring_attention.py) is asked for by
  name and passes through.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # large negative in float32; safe pre-softmax mask value


def allowed_mask(
    seq_len: int,
    window: int,
    pad_mask: Optional[torch.Tensor] = None,  # [B, L] 1 = real token
    device=None,
) -> torch.Tensor:
    """Bool [B or 1, 1, L, L]: causal AND (global OR in-window) AND key
    not padding; ``window`` 0 selects global attention."""
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    allowed = j <= i
    if window:
        allowed = allowed & ((i - j) < window)
    allowed = allowed[None, None]
    if pad_mask is not None:
        allowed = allowed & pad_mask[:, None, None, :].bool()
    return allowed


def attention_mask_bias(
    seq_len: int,
    window: int,
    pad_mask: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """Additive float32 bias [B or 1, 1, L, L]: 0 where allowed, -1e9
    elsewhere."""
    if pad_mask is not None:
        device = pad_mask.device
    allowed = allowed_mask(seq_len, window, pad_mask, device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(allowed, zero, torch.full_like(zero, NEG_INF))


def repeat_kv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Grouped-query head repeat: [B, Hkv, L, D] K/V to q's head count."""
    n_rep = q.shape[1] // k.shape[1]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=1)
        v = v.repeat_interleave(n_rep, dim=1)
    return k, v


def dot_product_attention(
    q: torch.Tensor,  # [B, H, L, D]
    k: torch.Tensor,  # [B, Hkv, L, D]
    v: torch.Tensor,  # [B, Hkv, L, D]
    bias: torch.Tensor,  # [B or 1, 1, L, L] additive float32
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked softmax(Q K^T) V with float32 scores and softmax; returns
    q's dtype."""
    k, v = repeat_kv(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores * scale + bias
    probs = attn_probs(torch.softmax(scores, dim=-1), q.dtype)
    return torch.matmul(probs, v)


def _attn_probs(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return p.to(dtype, copy=True)


# the softmax probabilities cast to the activation dtype, as a named op
# (JAX's checkpoint_name(probs, "attn_probs")) that the 'dots+probs' remat
# policy saves; always a fresh tensor
attn_probs = torch.library.custom_op("acco_tpu_torch::attn_probs", _attn_probs,
                                     mutates_args=(),
                                     schema="(Tensor p, ScalarType dtype) -> Tensor")


def _attn_probs_setup(ctx, inputs, output):
    ctx.in_dtype = inputs[0].dtype


def _attn_probs_backward(ctx, grad):
    return grad.to(ctx.in_dtype), None


attn_probs.register_autograd(_attn_probs_backward, setup_context=_attn_probs_setup)


def normalize_remat(value) -> "bool | str":
    """Config spellings of ``remat`` to False | True | 'dots' |
    'dots+probs' (the JAX package's one normalizer); anything else
    raises."""
    if isinstance(value, str):
        value = value.lower()
    if value in (False, None, 0, "0", "false", "no", "off", ""):
        return False
    if value in (True, 1, "1", "true", "yes", "on"):
        return True
    if value in ("dots", "dots+probs"):
        return value
    raise ValueError(
        f"remat must be False, True, 'dots', or 'dots+probs'; got {value!r}"
    )


def normalize_attention_impl(impl) -> str:
    """Config spellings (YAML bool / None included) to 'auto' | 'flash' |
    'fused' | 'xla' | 'ring'; anything else raises. 'ring' is only valid
    on a model built with a sequence group (context parallelism;
    ops/ring_attention.py)."""
    if impl in (True, "flash", "true", "True"):
        return "flash"
    if impl in (False, None, "xla", "false", "False"):
        return "xla"
    if impl in ("auto", "fused", "ring"):
        return impl
    raise ValueError(f"attention impl must be auto/flash/fused/xla/ring, got {impl!r}")


def resolve_attention_impl(impl, seq_len: int, head_dim: int, device, remat=False) -> str:
    """'xla', 'fused' or 'flash' for this shape on this device, under the
    model's ``remat`` (see module doc); 'ring' stays 'ring'."""
    from acco_tpu_torch.ops.flash_attention import supports_flash_attention
    from acco_tpu_torch.ops.fused_attention import supports_fused_attention

    impl = normalize_attention_impl(impl)
    remat = normalize_remat(remat)
    if impl != "auto":
        return impl
    if torch.device(device).type != "cuda":
        return "xla"
    threshold = 2048 if remat is False else 4096
    if (
        seq_len >= threshold
        and seq_len % 512 == 0
        and supports_flash_attention(seq_len, head_dim)
    ):
        return "flash"
    if supports_fused_attention(seq_len, head_dim):
        return "fused"
    return "xla"
