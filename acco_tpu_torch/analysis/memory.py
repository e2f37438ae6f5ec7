"""The memory sieve: the state bytes every placement implies, from the
rule tables, on the meta device (nothing allocated).

Counterpart of ``tools/hbm_check.py`` ``sweep_report`` (:319) and
``serve_report`` (:459), which price the JAX package's trees; this module
prices the port's own:

- :func:`sweep_report`: for every valid ``{dp, sp, tp, pp}``
  factorization of ``n_ranks`` and each preset of :data:`SWEEP_PRESETS`
  (both families), the mode's train state (``AccoState`` for acco and
  dpu, ``DDPState`` for ddp: :func:`abstract_train_state`, the global
  leaves as meta tensors) is walked with the mode's rule table
  (``sharding/tables.py`` ``train_state_table``), and each leaf costs its
  global bytes over the product of the mesh sizes of the axes its rule
  shards. The flat vector is ``ceil(n_params / (tp * pp))`` a model shard,
  padded to a multiple of dp x sp (the floor of ``parallel/tp.TpLayout``,
  which pads per leaf). The serve tree of the preset is priced the same
  way through ``serve_state_table``. Activations and transients are not
  in the floor: the card's run is the proof for the survivors.
- :func:`serve_report`: a serve config's replica: the params
  (``ServeEngine.abstract_params``, the model built on the meta device),
  the pools (``CacheSpec.abstract``), and the two big transients, the
  decode step's context gather over every slot (and GPT-Neo's band
  gather) and the top prefill bucket's float32 logits.

``python -m acco_tpu_torch.analysis --memory --ranks N`` and
``--serve config/serve/llama3-8b.yaml`` print them.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import torch

GB = 1024**3
H100_GB = 80.0
SWEEP_PRESETS = ("meta-llama/Meta-Llama-3-8B", "EleutherAI/gpt-neo-2.7B")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def spec_axes(spec) -> list:
    """The mesh axes a spec shards over (a tuple entry, the composed
    ``P(('pp', 'tp', 'dp'))``'s dim 0, contributes each member)."""
    axes = []
    for entry in spec:
        if entry is None:
            continue
        axes.extend(entry if isinstance(entry, tuple) else (str(entry),))
    return axes


def mesh_combos(n_ranks: int, num_heads: int, num_layers: int):
    """``(dp, tp, pp, sp)`` factorizations of ``n_ranks`` the port runs:
    the heads split over tp, the layers over pp; every composition of the
    four axes."""
    for dp in range(1, n_ranks + 1):
        if n_ranks % dp:
            continue
        rest = n_ranks // dp
        for tp in range(1, rest + 1):
            if rest % tp:
                continue
            rest2 = rest // tp
            for pp in range(1, rest2 + 1):
                if rest2 % pp:
                    continue
                sp = rest2 // pp
                if tp > 1 and num_heads % tp or pp > 1 and num_layers % pp:
                    continue
                yield dp, tp, pp, sp


def mesh_axes(tp: int, pp: int, sp: int) -> tuple:
    """``(shard_axes, model_axis)`` of a mesh, as the train step names them
    (``parallel/common.py`` ``FlatTrainStep``)."""
    shard_axes = ("dp", "sp") if sp > 1 else ("dp",)
    if tp > 1 and pp > 1:
        return shard_axes, ("pp", "tp")
    if tp > 1 or pp > 1:
        return shard_axes, "tp" if tp > 1 else "pp"
    return shard_axes, None


def abstract_train_state(mode: str, n_params: int, *, tp: int = 1, pp: int = 1,
                         ns: int = 1, param_dtype=torch.bfloat16):
    """The GLOBAL train state of ``mode`` over ``tp * pp`` model shards and
    ``ns`` (dp x sp) ZeRO-1 shards, as meta tensors of the port's state
    types: the flat vectors are the model shards' stacked, the pending
    gradients each shard's own [Pp], the counters scalars."""
    from acco_tpu_torch.ops.adamw import AdamWState
    from acco_tpu_torch.parallel.acco import AccoState
    from acco_tpu_torch.parallel.common import HealthState
    from acco_tpu_torch.parallel.ddp import DDPState
    from acco_tpu_torch.parallel.zero1 import Zero1State

    tpn = tp * pp
    padded = math.ceil(math.ceil(n_params / tpn) / ns) * ns

    def meta(n, dtype=torch.float32):
        return torch.empty(() if n is None else (n,), dtype=dtype, device="meta")

    zero1 = Zero1State(opt=AdamWState(meta(tpn * padded), meta(tpn * padded),
                                      meta(tpn * padded), meta(None, torch.int32)),
                       sched_grads=meta(None, torch.int32), grads_committed=meta(None))
    health = HealthState(meta(None, torch.int32), meta(None, torch.int32), meta(None))
    flat = meta(tpn * padded, param_dtype)
    if mode == "ddp":
        return DDPState(flat_params=flat, zero1=zero1, health=health)
    return AccoState(flat_params=flat, pending_grads=meta(tpn * ns * padded),
                     pending_count=meta(ns), zero1=zero1, round_idx=meta(None, torch.int32),
                     health=health)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def price_tree(tree, table, mesh_sizes: dict) -> dict:
    """``{path: bytes a rank holds}``: each leaf's global bytes over the
    product of the mesh sizes of the axes its rule shards."""
    from acco_tpu_torch.sharding.rules import leaf_paths

    out = {}
    for path, leaf in leaf_paths(tree):
        denom = 1
        for axis in spec_axes(table.match(path)):
            denom *= mesh_sizes[axis]
        out[path] = nbytes(leaf) / denom
    return out


def _preset_model(preset: str, dtype=torch.bfloat16):
    """The port's model of a preset (or a ``.json`` architecture) on the
    meta device."""
    from acco_tpu_torch.models.registry import _MODEL_TYPES, model_config

    model_type, cfg = model_config(preset, REPO_ROOT)
    return _MODEL_TYPES[model_type][1](cfg, dtype=dtype, device="meta")


def sweep_report(n_ranks: int, hbm_gb: float = H100_GB, mode: str = "acco",
                 presets=SWEEP_PRESETS, out: Optional[Callable] = print) -> list:
    """The train-state floor of every mesh of ``n_ranks`` and the serve
    tree, by rule table, for each preset (see the module's doc). Rows:
    ``{"preset", "dp", "tp", "pp", "sp", "per_leaf", "total", "fits"}``
    and one ``{"preset", "serve": True, "per_leaf", "total", "fits"}``."""
    from acco_tpu_torch.serve.engine import ServeEngine
    from acco_tpu_torch.sharding.tables import model_family, train_state_table

    say = out or (lambda *_: None)
    rows = []
    for preset in presets:
        model = _preset_model(preset)
        cfg = model.config
        say(f"\n== {preset} ({model_family(model)}): {model.n_params / 1e9:.2f}B params, "
            f"{n_ranks} ranks, train state floor by rule table (mode={mode}) ==")
        for dp, tp, pp, sp in mesh_combos(n_ranks, cfg.num_heads, cfg.num_layers):
            table = train_state_table(mode, *mesh_axes(tp, pp, sp))
            state = abstract_train_state(mode, model.n_params, tp=tp, pp=pp, ns=dp * sp,
                                         param_dtype=model.dtype)
            per_leaf = price_tree(state, table, {"dp": dp, "tp": tp, "pp": pp, "sp": sp})
            total = sum(per_leaf.values())
            fits = total <= hbm_gb * GB
            big = ", ".join(f"{p} {b / GB:.2f}" for p, b in sorted(per_leaf.items()) if b > 4)
            say(f"dp={dp} tp={tp} pp={pp} sp={sp}: state floor {total / GB:.2f} GB of "
                f"{hbm_gb:g} -> {'candidate' if fits else 'over'}  [{big} GB]")
            rows.append({"preset": preset, "dp": dp, "tp": tp, "pp": pp, "sp": sp,
                         "per_leaf": per_leaf, "total": total, "fits": fits})
        # hbm_check's serve sizing: pages of 16, 256 pages, 8 a sequence
        engine = ServeEngine(model, page_size=16, num_pages=256, max_pages_per_seq=8)
        table = engine.rule_table()
        per_leaf = price_tree(engine.abstract_state(), table, {})
        total = sum(per_leaf.values())
        pools = per_leaf["k_pages"] + per_leaf["v_pages"]
        say(f"serve ({table.name}): params {(total - pools) / GB:.2f} GB + KV pool "
            f"{pools / GB:.2f} GB = {total / GB:.2f} GB per serving rank (replicated)")
        rows.append({"preset": preset, "serve": True, "per_leaf": per_leaf, "total": total,
                     "fits": total <= hbm_gb * GB})
    return rows


def serve_report(serve_config: str, hbm_gb: float = H100_GB,
                 out: Optional[Callable] = print) -> dict:
    """One serving replica of ``serve_config`` priced on the meta device:
    the engine built as the serve CLI builds it (``serve/__main__.py``
    ``build_engine``), its ``abstract_state`` (params and pools), and the
    decode gather's and the top prefill bucket's transients."""
    import logging

    from acco_tpu_torch.configuration import load_yaml
    from acco_tpu_torch.serve.__main__ import build_engine
    from acco_tpu_torch.serve.kv_cache import band_pages

    say = out or (lambda *_: None)
    cfg = load_yaml(serve_config)
    engine, _ = build_engine(cfg, "meta", logging.getLogger(__name__), REPO_ROOT)
    model, spec, slots = engine.model, engine.spec, engine.max_slots
    tree = engine.abstract_state()
    from acco_tpu_torch.sharding.rules import leaf_paths

    params = [leaf for path, leaf in leaf_paths(tree) if path.startswith("params/")]
    n_params = sum(t.numel() for t in params)
    param_bytes = sum(nbytes(t) for t in params)
    pool_bytes = nbytes(tree["k_pages"]) + nbytes(tree["v_pages"])
    itemsize = tree["k_pages"].element_size()
    n_layers, n_kv, head_dim = model.kv_spec()
    # decode gathers every slot's whole context (K and V), and GPT-Neo's
    # local layers their band beside it where it is narrower
    decode_ws = 2 * n_layers * slots * spec.max_context * n_kv * head_dim * itemsize
    mcfg = model.config
    windows = getattr(mcfg, "layer_windows", None)
    if windows and any(w > 0 for w in windows):
        bp = band_pages(mcfg.window_size, spec.page_size)
        if bp < spec.max_pages_per_seq:
            decode_ws += 2 * n_layers * slots * bp * spec.page_size * n_kv * head_dim * itemsize
    prefill_ws = engine.buckets[-1] * model.padded_vocab * 4  # the top bucket's fp32 logits
    peak = param_bytes + pool_bytes + max(decode_ws, prefill_ws)
    fits = peak <= hbm_gb * GB
    say(f"serve model={cfg.get('model')} layers={mcfg.num_layers} hidden={mcfg.hidden_size} "
        f"vocab={mcfg.vocab_size} | page_size={spec.page_size} num_pages={spec.num_pages} "
        f"max_pages_per_seq={spec.max_pages_per_seq} slots={slots} buckets={engine.buckets}")
    say(f"params: {param_bytes / GB:.2f} GB {spec.dtype} ({n_params} params)")
    say(f"kv pool: {pool_bytes / GB:.2f} GB ({spec.num_pages} pages x "
        f"{spec.page_bytes / 2**20:.2f} MiB)")
    say(f"workspace: decode context gather {decode_ws / GB:.2f} GB, prefill "
        f"bucket-{engine.buckets[-1]} logits {prefill_ws / GB:.2f} GB")
    say(f"PEAK (meta-tensor lower bound): {peak / GB:.2f} GB of {hbm_gb:g} GB -> "
        f"{'fits' if fits else 'DOES NOT FIT'}")
    return {"n_params": n_params, "param_bytes": param_bytes, "pool_bytes": pool_bytes,
            "decode_ws": decode_ws, "prefill_ws": prefill_ws, "peak": peak, "fits": fits}
