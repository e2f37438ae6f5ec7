"""The port's ring block (K4's plain version on the CPU) against the JAX
package's ``block_attention_partial`` run through its Pallas kernel in
interpret mode: the partial (o, m, l) and its VJP with random cotangents
on all three outputs, as the ring's merge produces them. float32.

Cases: the three masks (none, diag, positional at window 0 and 3, both at
a zig-zag hop whose rows are partly or fully masked and at a self hop),
MHA and GQA, and planted ties at the row max (three equal keys), where the
cotangent on m splits evenly over the tied entries.

Tolerances are the JAX suite's (tests/test_block_attention.py:58,86):
1e-5 on the forward, 2e-4 on the gradients.

The Hopper kernel cannot run here (no card, no nvcc); chip_smoke.py holds
it against the same plain version on the card. What this file checks
about it is that a tensor off the CPU never reaches the plain version.
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acco_tpu.ops.block_attention import block_attention_partial as jax_block
from acco_tpu_torch.ops import block_attention as port
from acco_tpu_torch.ops.ring_attention import zigzag_positions
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

B, H, L, D = 2, 4, 32, 64
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
# (diag, (query rank, key rank) of a zig-zag layout of 2 L tokens over 2
# ranks, window): rank 1's queries against rank 0's keys (with window 3
# most rows see no key: fully masked) and rank 0's self hop
VARIANTS = {
    "full": (False, None, 0),
    "diag": (True, None, 0),
    "hop-w0": (False, (1, 0), 0),
    "hop-w3": (False, (1, 0), 3),
    "self-w3": (False, (0, 0), 3),
}


def _inputs(seed, hkv, ties=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, L, D)).astype(np.float32)
    k = rng.standard_normal((B, hkv, L, D)).astype(np.float32)
    v = rng.standard_normal((B, hkv, L, D)).astype(np.float32)
    if ties:
        u = rng.standard_normal(D).astype(np.float32)
        q = q + u
        k[:, :, [3, 4, 5]] = 2 * u
    cot = (
        rng.standard_normal((B, H, L, D)).astype(np.float32),
        rng.standard_normal((B, H, L)).astype(np.float32),
        rng.standard_normal((B, H, L)).astype(np.float32),
    )
    return (q, k, v), cot


def _positions(variant):
    diag, ranks, window = VARIANTS[variant]
    if ranks is None:
        return diag, None, None, window
    qp, kp = (zigzag_positions(2 * L, 2, r).numpy().astype(np.int32) for r in ranks)
    return diag, qp, kp, window


def _jax(qkv, cot, variant):
    diag, qp, kp, window = _positions(variant)

    def f(q, k, v):
        return jax_block(
            q, k, v, diag=diag, interpret=True,
            q_positions=None if qp is None else jnp.asarray(qp),
            kv_positions=None if kp is None else jnp.asarray(kp),
            window=window,
        )

    @jax.jit
    def run(qkv, cot):
        out, vjp = jax.vjp(f, *qkv)
        return out, vjp(cot)

    out, grads = run(tuple(jnp.asarray(x) for x in qkv), tuple(jnp.asarray(c) for c in cot))
    return [np.asarray(x) for x in out], [np.asarray(g) for g in grads]


def _port(qkv, cot, variant):
    diag, qp, kp, window = _positions(variant)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in qkv)
    out = port.block_attention_partial(
        tq, tk, tv, diag=diag,
        q_positions=None if qp is None else torch.tensor(qp),
        kv_positions=None if kp is None else torch.tensor(kp),
        window=window,
    )
    grads = torch.autograd.grad(out, (tq, tk, tv), tuple(torch.tensor(c) for c in cot))
    return [x.detach().numpy() for x in out], [g.numpy() for g in grads]


@pytest.mark.parametrize("hkv", [H, 2, 1], ids=["mha", "gqa2", "gqa4"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_partial_and_vjp_match_jax(variant, hkv):
    qkv, cot = _inputs(0, hkv)
    (o_j, m_j, l_j), g_j = _jax(qkv, cot, variant)
    (o_t, m_t, l_t), g_t = _port(qkv, cot, variant)
    for name, got, want in (("o", o_t, o_j), ("m", m_t, m_j), ("l", l_t, l_j)):
        np.testing.assert_allclose(got, want, err_msg=name, **FWD_TOL)
    for name, got, want in zip(("dq", "dk", "dv"), g_t, g_j):
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("variant", ["full", "diag", "hop-w0", "self-w3"])
def test_planted_ties_split_the_max_cotangent(variant):
    """Three equal keys at each row's max: both sides count three maxima
    and split dm over them; the gradients agree with JAX's."""
    qkv, cot = _inputs(1, 2, ties=True)
    (o_j, m_j, l_j), g_j = _jax(qkv, cot, variant)
    diag, qp, kp, window = _positions(variant)
    *_, cnt = port.block_fwd_reference(
        *(torch.tensor(x) for x in qkv), diag,
        None if qp is None else torch.tensor(qp), None if kp is None else torch.tensor(kp), window,
    )
    assert int((cnt == 3).sum()) >= B * H  # rows that see all three tied keys
    (o_t, m_t, l_t), g_t = _port(qkv, cot, variant)
    np.testing.assert_allclose(o_t, o_j, **FWD_TOL)
    np.testing.assert_allclose(m_t, m_j, **FWD_TOL)
    for name, got, want in zip(("dq", "dk", "dv"), g_t, g_j):
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)


def test_fully_masked_rows():
    """A row with no allowed key: m = -1e9, p = 1 on every key (l = Lk,
    o = the sum of V), and no gradient into q through it."""
    qkv, cot = _inputs(2, 2)
    (o, m, l), (dq, _, _) = _port(qkv, cot, "hop-w3")
    _, qp, kp, window = _positions("hop-w3")
    empty = ~((kp[None, :] <= qp[:, None]) & (kp[None, :] > qp[:, None] - window)).any(1)
    assert empty.sum() > L // 2
    np.testing.assert_array_equal(m[:, :, empty], -1e9)
    np.testing.assert_array_equal(l[:, :, empty], L)
    v_sum = np.repeat(qkv[2], H // 2, axis=1).sum(2, keepdims=True)
    np.testing.assert_allclose(o[:, :, empty], np.broadcast_to(v_sum, o[:, :, empty].shape),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(dq[:, :, empty], 0.0)


def test_rowc_reference_is_the_common_term():
    """c = (dm - sum(p dp)) / cnt, with sum(p dp) from the delta trick,
    equals the explicit row sum over the block's p and dp."""
    (q, k, v), (do, dm, dl) = (tuple(map(torch.tensor, x)) for x in _inputs(3, 2))
    o, m, l, cnt = port.block_fwd_reference(q, k, v, diag=True)
    kr, vr = port.repeat_kv(q, k, v)
    s = port._masked_scores(q, kr, port.block_mask(L, L, True), D ** -0.5)
    p = torch.exp(s - m[..., None])
    dp = do @ vr.transpose(-1, -2) + dl[..., None]
    want = (dm - (p * dp).sum(-1)) / cnt
    torch.testing.assert_close(port.block_rowc_reference(o, do, dm, dl, l, cnt), want,
                               rtol=1e-5, atol=1e-4)


def test_envelope():
    assert port.supports_block_attention(64, 64, 64)
    assert port.supports_block_attention(4096, 4096, 128)
    assert port.supports_block_attention(128, 1088, 64)  # Lq != Lk, no cap
    assert not port.supports_block_attention(32, 64, 64)
    assert not port.supports_block_attention(1000, 1024, 64)
    assert not port.supports_block_attention(1024, 1024, 96)


def test_off_cpu_tensor_launches_kernel_or_raises(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel: with no kernel
    build the call raises, and the plain version is never called."""

    def no_build():
        raise RuntimeError("no kernel build")

    def plain_called(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(port, "_library", no_build)
    monkeypatch.setattr(port, "block_fwd_reference", plain_called)
    q = torch.empty(1, 4, 128, 64, device="meta")
    kv = torch.empty(1, 2, 128, 64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel build"):
        port.block_attention_partial(q, kv, kv, diag=True)


def test_wrapper_refuses_cpu_tensors_and_bad_shapes(monkeypatch):
    """The kernel wrappers take CUDA tensors only, checked before launch."""
    monkeypatch.setattr(port, "_library", lambda: None)
    q = torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs CUDA"):
        port.blk_fwd(q, q, q, port.MODES["full"], None, None, 0, 0.125)
    with pytest.raises(ValueError, match="diag mask needs Lq == Lk"):
        port.blk_fwd(q, q[:, :, :64].contiguous(), q[:, :, :64].contiguous(),
                     port.MODES["diag"], None, None, 0, 0.125)
    with pytest.raises(ValueError, match="q_pos must be int32"):
        port.blk_fwd(q, q, q, port.MODES["pos"], None, None, 0, 0.125)


def test_ctypes_signatures_match_the_c_launchers():
    """Each launcher's argtypes list the C function's parameters in order
    (ctypes would pass a pointer or a float where an int is expected)."""
    src = open(os.path.join(os.path.dirname(port.__file__), "..", "csrc",
                            "block_attention.cu")).read()
    kinds = {"int": ctypes.c_int, "long": ctypes.c_long, "float": ctypes.c_float}
    for fn, argtypes in port._SIGNATURES.items():
        params = re.search(rf"int {fn}\(([^)]*)\)", src).group(1).split(",")
        want = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]] for p in params]
        assert argtypes == want, fn


# The kernels' rule on two spans of positions, (min, max) of a tile of
# queries and of a tile of keys (csrc/block_attention.cu, BlockMask):
# `meets` -- some pair may be allowed (else the walk skips the tile);
# `covers` -- every pair is allowed (else the tile is masked element-wise).
def _meets(qs, ks, window):
    return ks[0] <= qs[1] and (window == 0 or ks[1] > qs[0] - window)


def _covers(qs, ks, window):
    return ks[1] <= qs[0] and (window == 0 or ks[0] > qs[1] - window)


def _layouts():
    """(query positions, key positions) of zig-zag hops and self hops at sp
    2 and 4, a contiguous hop, and a random permutation of positions."""
    out = []
    for length, ranks in ((512, 2), (1024, 4)):
        for qr, kr in ((1, 0), (0, 0), (ranks - 1, 0)):
            out.append((zigzag_positions(length, ranks, qr), zigzag_positions(length, ranks, kr)))
    out.append((torch.arange(256, 512), torch.arange(0, 384)))
    g = torch.Generator().manual_seed(4)
    out.append((torch.randperm(384, generator=g), torch.randperm(384, generator=g)[:192]))
    return out


def test_spans_are_each_tiles_min_and_max():
    pos = zigzag_positions(512, 2, 1)
    got = port.positions_with_spans(pos)
    n = pos.numel()
    assert got.dtype == torch.int32 and got.shape == (n + 2 * n // 64,)
    np.testing.assert_array_equal(got[:n].numpy(), pos.numpy())
    tiles = pos.view(-1, 64)
    np.testing.assert_array_equal(got[n::2].numpy(), tiles.amin(1).numpy())
    np.testing.assert_array_equal(got[n + 1::2].numpy(), tiles.amax(1).numpy())
    # the wrappers take plain positions or positions with their spans
    assert port._spanned(pos.to(torch.int32), n).numel() == got.numel()
    assert port._spanned(got, n) is got


@pytest.mark.parametrize("window", [0, 3, 48, 100, 256])
@pytest.mark.parametrize("tiles", [(64, 64), (128, 128), (128, 64), (64, 128)])
def test_tile_skip_and_mask_rule_against_the_plain_mask(window, tiles):
    """The spans' rule never skips a tile that holds an allowed pair, and
    never leaves unmasked a tile that holds a masked one (block_mask is
    the plain version's mask), over the kernels' tilings: 128-row blocks
    against 128-key tiles (the forward), 64-key steps (dQ), 128-key blocks
    against 64-query steps (dK/dV)."""
    tq, tk = tiles
    for q_pos, kv_pos in _layouts():
        allowed = port.block_mask(len(q_pos), len(kv_pos), False, q_pos, kv_pos, window)
        qs_all = port.positions_with_spans(q_pos)[len(q_pos):].view(-1, 2)
        ks_all = port.positions_with_spans(kv_pos)[len(kv_pos):].view(-1, 2)

        def span(spans, i0, n):  # over the 64-position tiles of [i0, i0 + n)
            s = spans[i0 // 64:(i0 + n) // 64]
            return int(s[:, 0].min()), int(s[:, 1].max())

        for i0 in range(0, len(q_pos), tq):
            for j0 in range(0, len(kv_pos), tk):
                block = allowed[i0:i0 + tq, j0:j0 + tk]
                qs, ks = span(qs_all, i0, tq), span(ks_all, j0, tk)
                if bool(block.any()):
                    assert _meets(qs, ks, window), (i0, j0)
                if _covers(qs, ks, window):
                    assert bool(block.all()), (i0, j0)
