"""Standalone perplexity evaluation of a model the port (or the JAX
package) trained.

Counterpart of ``perplexity_eval.py``: batched shifted NLL, the
attention-masked per-sample mean, ``exp``, per-sample perplexities and
their mean. The model is built from ``config/model/<name>.yaml`` and
takes its weights from a checkpoint's portable ``params.npz``
(``utils/checkpoint.load_flat_params``: a final save of this port or of
the JAX package; a checkpoint root resolves to its newest complete
step), or is freshly initialised from a seed without one. With
``--hf-checkpoint`` (a local HF checkpoint directory, or a hub name under
``$ACCO_MODELS_ROOT``) the model and its weights come from that
checkpoint (``models/hf_loader.from_pretrained``; JAX:
perplexity_eval.py:143-146) and its tokenizer from the same directory
where it holds one. ::

    python -m acco_tpu_torch.perplexity_eval --model llama-125M \\
        --checkpoint outputs/.../checkpoints/acco
    python -m acco_tpu_torch.perplexity_eval --hf-checkpoint /models/gpt-neo-125M
    python -m acco_tpu_torch.perplexity_eval --device cpu --model tiny128 \\
        --n-samples 8 --max-length 128

It runs on ``cuda:0`` unless ``--device cpu`` is given. The texts are the
train split of ``--data`` (``synthetic``, or a dataset that
``data/datasets.py`` loads). ``--engine serve`` scores each sample
through the serving path's forward (``serve/engine.ServeEngine.
score_nll``: ``model.prefill`` at the sample's bucket, no KV page
touched), on an engine sized as JAX's (page 16, buckets up to
``--max-length`` clamped to the model's positions).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(model_name: str, repo_root: str = REPO_ROOT, device="cpu", dtype=torch.bfloat16,
          attention: str = "auto"):
    """``(model, model_cfg)`` for ``config/model/<model_name>.yaml``."""
    from acco_tpu_torch.configuration import load_yaml
    from acco_tpu_torch.models.registry import build_model

    model_cfg = load_yaml(os.path.join(repo_root, "config", "model", model_name + ".yaml"))
    model = build_model(model_cfg, repo_root=repo_root, dtype=dtype, attention=attention,
                        device=device)
    return model, model_cfg


def compute(
    model,
    flat_params: torch.Tensor,
    tokenizer,
    texts: list[str],
    batch_size: int = 8,
    max_length: int = 256,
    add_start_token: bool = True,
    engine=None,
) -> dict:
    """Per-sample perplexities of ``texts`` under ``flat_params`` (an
    [n_params] vector in the model's flat order) and their mean, as the
    JAX ``compute`` gives them: BOS (or EOS) prepended, each sample padded
    to ``max_length``, the NLL of its next-token targets averaged over
    its real tokens. With ``engine`` (a ``serve.engine.ServeEngine`` on
    ``model``) each sample is scored alone through ``engine.score_nll``."""
    from acco_tpu_torch.data.loader import IGNORE_INDEX
    from acco_tpu_torch.ops.losses import _per_token_ce

    bos = getattr(tokenizer, "bos_token_id", None)
    if bos is None:
        bos = tokenizer.eos_token_id
    pad = tokenizer.pad_token_id
    if pad is None:
        pad = tokenizer.eos_token_id

    encoded = tokenizer(texts, truncation=True, max_length=max_length)["input_ids"]
    encoded = [([bos] + list(ids) if add_start_token else list(ids)) for ids in encoded]
    encoded = [ids[:max_length] for ids in encoded]

    if engine is not None:
        engine.set_params(flat_params)
        ppls = []
        for ids in encoded:
            nll_sum, n_tok = engine.score_nll(ids)
            ppls.append(float(np.exp(nll_sum / max(n_tok, 1.0))))
        return {"perplexities": ppls, "mean_perplexity": float(np.mean(ppls))}

    device = next(model.parameters()).device
    model.load_flat(flat_params.to(device=device, dtype=model.dtype))
    ppls = []
    with torch.no_grad():
        for start in range(0, len(encoded), batch_size):
            rows = encoded[start : start + batch_size]
            bs = len(rows)
            ids = np.full((bs, max_length), pad, np.int64)
            am = np.zeros((bs, max_length), np.int64)
            labels = np.full((bs, max_length), IGNORE_INDEX, np.int64)
            for i, r in enumerate(rows):
                ids[i, : len(r)] = r
                am[i, : len(r)] = 1
                labels[i, : len(r)] = r
            ids, am, labels = (torch.from_numpy(x).to(device) for x in (ids, am, labels))
            logits = model.apply(ids, am)
            nll, mask = _per_token_ce(logits[:, :-1], labels[:, 1:], 0.0)
            per_sample = (nll * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)
            ppls.extend(torch.exp(per_sample).cpu().tolist())
    return {"perplexities": ppls, "mean_perplexity": float(np.mean(ppls))}


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", default="gptneo", help="config/model/<name>.yaml")
    parser.add_argument("--checkpoint", default=None,
                        help="a step_N dir or a checkpoint root (its newest complete step)")
    parser.add_argument("--hf-checkpoint", default=None,
                        help="a local HF checkpoint dir (or a hub name under ACCO_MODELS_ROOT)")
    parser.add_argument("--data", default="synthetic", help="'synthetic' or a dataset path")
    parser.add_argument("--n-samples", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--max-length", type=int, default=256)
    parser.add_argument("--no-bos", action="store_true")
    parser.add_argument("--engine", choices=("jit", "serve"), default="jit",
                        help="'serve' scores through the serving path's prefill forward "
                             "(ServeEngine.score_nll) instead of the model's apply")
    parser.add_argument("--device", default=None, help="cpu, or the card (default)")
    parser.add_argument("--seed", type=int, default=0, help="init seed without --checkpoint")
    args = parser.parse_args(argv)

    from acco_tpu_torch.data.datasets import load_text_dataset
    from acco_tpu_torch.data.tokenizer import load_tokenizer
    from acco_tpu_torch.utils.checkpoint import load_flat_params, resolve_serving_checkpoint
    from acco_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    if args.hf_checkpoint:
        from acco_tpu_torch.models.hf_loader import from_pretrained, resolve_pretrained_dir

        ckpt_dir = resolve_pretrained_dir(args.hf_checkpoint)
        model, flat = from_pretrained(ckpt_dir, device=device)
        tokenizer = load_tokenizer(ckpt_dir)
    else:
        model, model_cfg = build(args.model, device=device)
        tokenizer = load_tokenizer(model_cfg.get("tokenizer"))
        if args.checkpoint:
            step_dir = resolve_serving_checkpoint(args.checkpoint)
            flat = torch.from_numpy(load_flat_params(step_dir, model.n_params))
        else:
            flat = model.init_flat(torch.Generator(device=device).manual_seed(args.seed))
    train_texts, _ = load_text_dataset({"path": args.data}, test_size=0.01)
    texts = train_texts[: args.n_samples]
    engine, max_length = None, args.max_length
    if args.engine == "serve":
        from acco_tpu_torch.serve.engine import ServeEngine

        # a scoring-only engine: score_nll never touches the KV pool, so
        # the page budget is a formality; the buckets cover the eval's
        # max_length, clamped to the model's position table (JAX:
        # perplexity_eval.py:169-185)
        page = 16
        ctx = min(max_length, model.config.max_position_embeddings)
        ctx = max(page, (ctx // page) * page)
        max_length = min(max_length, ctx)
        engine = ServeEngine(model, page_size=page, num_pages=2, max_pages_per_seq=ctx // page,
                             max_slots=1)
    result = compute(model, flat, tokenizer, texts, batch_size=args.batch_size,
                     max_length=max_length, add_start_token=not args.no_bos, engine=engine)
    out = {"mean_perplexity": result["mean_perplexity"], "n": len(texts)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
