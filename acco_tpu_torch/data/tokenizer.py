"""Tokenizer loading with the byte-level fallback.

Counterpart of ``acco_tpu/data/tokenizer.py``: :func:`load_tokenizer`
tries an HF tokenizer from the local cache only (``local_files_only``:
never the network) and otherwise falls back to :class:`ByteTokenizer`
with the same loud warning. The machine with the card has no
``transformers``, so there every HF name takes the fallback.
"""

from __future__ import annotations

import logging
from typing import Iterable, List, Optional, Union

_module_log = logging.getLogger(__name__)


class ByteTokenizer:
    """Byte-level tokenizer: vocab = 256 byte values + EOS."""

    def __init__(self) -> None:
        self.eos_token_id = 256
        self.pad_token_id = 256  # pad = eos, as the reference sets it
        self.vocab_size = 257
        self.eos_token = "<|eos|>"
        self.pad_token = self.eos_token
        self.name_or_path = "byte-level-fallback"

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Iterable[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    def __call__(
        self,
        texts: Union[str, List[str]],
        truncation: bool = False,
        max_length: Optional[int] = None,
        **_: object,
    ) -> dict:
        if isinstance(texts, str):
            texts = [texts]
        input_ids = []
        attention_mask = []
        for t in texts:
            ids = self.encode(t)
            if truncation and max_length is not None:
                ids = ids[:max_length]
            input_ids.append(ids)
            attention_mask.append([1] * len(ids))
        return {"input_ids": input_ids, "attention_mask": attention_mask}

    def __len__(self) -> int:
        return self.vocab_size


def load_tokenizer(name_or_path: str, log=None):
    """An HF tokenizer from the local cache, else the byte-level fallback."""
    if name_or_path in (None, "", "byte", "byte-level-fallback"):
        return ByteTokenizer()
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)
        # a model checkpoint directory with no tokenizer files can give a
        # tokenizer with no vocabulary, which encodes every text to nothing
        if not tok("a b")["input_ids"]:
            raise ValueError("the tokenizer encodes text to no ids (no vocabulary)")
        if tok.pad_token is None:
            tok.pad_token = tok.eos_token
        return tok
    except Exception as exc:  # no transformers / not cached: degrade loudly
        (log or _module_log).warning(
            "Could not load tokenizer %r (%s: %s); using the byte-level "
            "fallback (vocab 257) — token/loss scales will differ",
            name_or_path,
            type(exc).__name__,
            exc,
        )
        return ByteTokenizer()
