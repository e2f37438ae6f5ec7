"""The port's ring attention on 2 and 4 gloo ranks against the JAX ring on
as many virtual CPU devices, and against dense causal attention.

Each rank is a process of its own (tests/torch_ranks.py) that runs the
port's ``ring_attention``, ``zigzag_ring_attention`` and
``windowed_ring_attention`` on its chunk, forward and backward (the
backward crosses the ring through the exchange's own backward), with both
block impls: 'fused' (K4, whose plain version runs on the CPU) and 'xla'
(the jnp-form block). The parent gathers the chunks and compares them with
JAX's ring under ``shard_map`` (its 'auto' block: the jnp form on the
CPU) and with the dense attention of the JAX package. float32.

Tolerances are tests/test_ring_attention.py's: 2e-5 on the output
(:49), 5e-5 on the gradients (:75, against dense attention).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from acco_tpu.ops import ring_attention as jax_ring
from acco_tpu.ops.attention import attention_mask_bias, dot_product_attention
from acco_tpu_torch.ops import ring_attention as port
import torch_ranks
from torch_ranks import Ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

B, H, L, D = 2, 4, 64, 8
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
# layout -> (kv heads, window); 'win-*' are the windowed ring (window 0 =
# global causal), the others the causal rings
LAYOUTS = {
    "contiguous": (2, 0),
    "zigzag": (2, 0),
    "win-zigzag": (H, 5),
    "win-contiguous": (H, 0),
}
IMPLS = ("fused", "xla")

WORKER = """
import json
import numpy as np
from acco_tpu_torch.ops import ring_attention as ra

sg = ra.SequenceGroup.of()
data = np.load(os.path.join(WORKDIR, "inputs.npz"))
layouts = json.load(open(os.path.join(WORKDIR, "layouts.json")))
L = data["q"].shape[2]
lc = L // WS
out = {}
for layout, (hkv, window) in layouts.items():
    zig = layout.endswith("zigzag")
    arrays = [data["q"], data[f"k{hkv}"], data[f"v{hkv}"], data["cot"]]
    if zig:
        perm = ra.zigzag_permutation(L, WS)[0]
        arrays = [x[:, :, perm] for x in arrays]
    chunk = [np.ascontiguousarray(x[:, :, RANK * lc:(RANK + 1) * lc]) for x in arrays]
    if zig:
        positions = lambda r: ra.zigzag_positions(L, WS, r)
    else:
        positions = lambda r: r * lc + torch.arange(lc)
    for impl in ("fused", "xla"):
        q, k, v = (torch.tensor(x, requires_grad=True) for x in chunk[:3])
        if layout.startswith("win"):
            o = ra.windowed_ring_attention(q, k, v, sg, window, positions(RANK), positions,
                                           block_impl=impl)
        elif zig:
            o = ra.zigzag_ring_attention(q, k, v, sg, block_impl=impl)
        else:
            o = ra.ring_attention(q, k, v, sg, block_impl=impl)
        o.backward(torch.tensor(chunk[3]))
        for name, t in (("o", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            out[f"{layout}/{impl}/{name}"] = t.detach().numpy()
np.savez(os.path.join(WORKDIR, f"out{RANK}.npz"), **out)
"""


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    arrays = {"q": (B, H, L, D), "k2": (B, 2, L, D), "v2": (B, 2, L, D),
              f"k{H}": (B, H, L, D), f"v{H}": (B, H, L, D), "cot": (B, H, L, D)}
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in arrays.items()}


def _jax_ring(layout, ws, q, k, v, cot, window):
    """JAX's ring on ``ws`` virtual devices: (output, dq, dk, dv), in the
    global (un-permuted) order."""
    mesh = Mesh(np.array(jax.devices()[:ws]), ("sp",))
    zig = layout.endswith("zigzag")
    perm, inv = jax_ring.zigzag_permutation(L, ws) if zig else (np.arange(L),) * 2
    lc = L // ws

    def body(q, k, v):
        if layout.startswith("win"):
            idx = jax.lax.axis_index("sp")
            if zig:
                pos = lambda r: jax_ring.zigzag_positions(L, ws, r)
            else:
                pos = lambda r: r * lc + jnp.arange(lc)
            return jax_ring.windowed_ring_attention(q, k, v, "sp", window, pos(idx), pos)
        fn = jax_ring.zigzag_ring_attention if zig else jax_ring.ring_attention
        return fn(q, k, v, "sp")

    spec = P(None, None, "sp")
    ring = jax.shard_map(body, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                         check_vma=False)
    @jax.jit
    def run(q, k, v, cot):
        out, vjp = jax.vjp(ring, q, k, v)
        return (out, *vjp(cot))

    outs = run(*(jnp.asarray(x[:, :, perm]) for x in (q, k, v, cot)))
    return [np.asarray(x)[:, :, inv] for x in outs]


def _dense(q, k, v, cot, window):
    def f(q, k, v):
        return dot_product_attention(q, k, v, attention_mask_bias(L, window, None))

    @jax.jit
    def run(q, k, v, cot):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(cot))

    return [np.asarray(x) for x in run(*(jnp.asarray(x) for x in (q, k, v, cot)))]


@pytest.mark.parametrize("ws", [2, 4])
def test_ring_matches_jax_ring_and_dense(ws, tmp_path):
    data = _inputs()
    np.savez(tmp_path / "inputs.npz", **data)
    (tmp_path / "layouts.json").write_text(json.dumps(LAYOUTS))
    ranks = Ranks(WORKER, ws, tmp_path)  # beside JAX's rings and the dense reference
    want = {}
    for layout, (hkv, window) in LAYOUTS.items():
        q, k, v, cot = data["q"], data[f"k{hkv}"], data[f"v{hkv}"], data["cot"]
        want[layout] = (_jax_ring(layout, ws, q, k, v, cot, window), _dense(q, k, v, cot, window))
    ranks.join()
    parts = [np.load(tmp_path / f"out{r}.npz") for r in range(ws)]
    for layout, (hkv, window) in LAYOUTS.items():
        jax_out, dense = want[layout]
        inv = (jax_ring.zigzag_permutation(L, ws)[1] if layout.endswith("zigzag")
               else np.arange(L))
        for impl in IMPLS:
            for i, name in enumerate(("o", "dq", "dk", "dv")):
                got = np.concatenate([p[f"{layout}/{impl}/{name}"] for p in parts], axis=2)
                got = got[:, :, inv]
                tol = FWD_TOL if name == "o" else GRAD_TOL
                what = f"ws {ws} {layout} {impl} {name}"
                np.testing.assert_allclose(got, jax_out[i], err_msg=what + " vs JAX ring", **tol)
                np.testing.assert_allclose(got, dense[i], err_msg=what + " vs dense", **tol)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_one_rank_ring_matches_dense(layout, impl):
    """A sequence group of one rank runs no hop: each layout is then its
    self blocks alone (the card's ring path), and equals dense attention."""
    data = _inputs(1)
    hkv, window = LAYOUTS[layout]
    q, k, v, cot = data["q"], data[f"k{hkv}"], data[f"v{hkv}"], data["cot"]
    sg = port.SequenceGroup(group=None, size=1, rank=0)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    if layout.startswith("win"):
        o = port.windowed_ring_attention(tq, tk, tv, sg, window, torch.arange(L),
                                         lambda r: torch.arange(L), block_impl=impl)
    elif layout == "zigzag":
        o = port.zigzag_ring_attention(tq, tk, tv, sg, block_impl=impl)
    else:
        o = port.ring_attention(tq, tk, tv, sg, block_impl=impl)
    o.backward(torch.tensor(cot))
    dense = _dense(q, k, v, cot, window)
    for got, want, tol in zip((o.detach(), tq.grad, tk.grad, tv.grad), dense,
                              (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(got.numpy(), want, **tol)  # lint: host-sync-ok: a CPU tensor read in an assertion loop


@pytest.mark.parametrize("ws", [1, 2, 4, 8])
def test_zigzag_layout_matches_jax(ws):
    perm, inv = port.zigzag_permutation(L, ws)
    jperm, jinv = jax_ring.zigzag_permutation(L, ws)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)
    for r in range(ws):
        np.testing.assert_array_equal(port.zigzag_positions(L, ws, r).numpy(),  # lint: host-sync-ok: a CPU tensor read in an assertion loop
                                      np.asarray(jax_ring.zigzag_positions(L, ws, r)))
    with pytest.raises(ValueError, match="divisible by 2\\*ws"):
        port.zigzag_permutation(L + 1, ws)


def test_maximum_splits_a_tie_as_jax_does():
    """The merge's running max: torch.maximum gives each side half the
    gradient on a tie, as jnp.maximum does, and all of it otherwise."""
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = np.array([1.0, 5.0, 0.0], np.float32)
    ta, tb = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    torch.maximum(ta, tb).sum().backward()
    ga, gb = jax.grad(lambda x, y: jnp.maximum(x, y).sum(), argnums=(0, 1))(a, b)
    np.testing.assert_array_equal(ta.grad.numpy(), np.asarray(ga))
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(gb))
    np.testing.assert_array_equal(ta.grad.numpy(), [0.5, 0.0, 1.0])


def test_merge_matches_jax():
    rng = np.random.default_rng(3)
    parts = [rng.standard_normal(s).astype(np.float32)
             for s in [(B, H, 8, D), (B, H, 8), (B, H, 8)] * 2]
    parts[4][:, :, :3] = parts[1][:, :, :3]  # tied maxima in a few rows
    got = port._merge(*map(torch.tensor, parts))
    want = jax_ring._merge(*map(jnp.asarray, parts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)  # lint: host-sync-ok: a CPU tensor read in an assertion loop


def test_block_impl_names():
    assert port._resolve_block_impl("auto", "cpu") == "xla"
    assert port._resolve_block_impl("auto", torch.device("cuda", 0)) == "fused"
    assert port._resolve_block_impl("fused", "cpu") == "fused"
    with pytest.raises(ValueError, match="auto/xla/fused"):
        port._resolve_block_impl("pallas", "cpu")
