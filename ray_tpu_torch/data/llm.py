"""LM data pipeline: text -> tokens -> packed fixed-length sequences. Ported
from ``ray_tpu/data/llm.py``.

Role parity: the reference's ray.data LLM preprocessing recipes (map_batches
tokenize -> group into blocks); here it's a first-class helper closing the
data->train loop for the in-tree Transformer: every output row is a dense
``{"tokens": int32[seq_len]}`` — exactly what make_lm_train_step consumes
(static shapes).

Tokenizers: ByteTokenizer (in-tree, zero deps — byte-level LM convention)
or any object with ``encode(text) -> list[int]`` (e.g. a transformers
tokenizer when available).

Where the port differs from the JAX module: the packing function is the
module-level ``_pack`` bound with ``functools.partial``, where the JAX
module maps a closure, because the port sends a data function to cluster
workers by import path (ROADMAP.md C). The rows are the same.
"""

from __future__ import annotations

import functools
from typing import Any, List, Optional

import numpy as np


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: vocab = 256 bytes + BOS/EOS."""

    BOS = 256
    EOS = 257
    vocab_size = 258

    def encode(self, text: str) -> List[int]:
        return [self.BOS, *text.encode("utf-8"), self.EOS]

    def decode(self, tokens) -> str:
        data = bytes(t for t in tokens if 0 <= int(t) < 256)
        return data.decode("utf-8", errors="replace")


def _pack(batch, *, seq_len: int, tok: Any, text_column: str):
    stream: List[int] = []
    for text in batch[text_column]:
        stream.extend(tok.encode(str(text)))
    n = (len(stream) // seq_len) * seq_len
    if n == 0:
        return {"tokens": np.zeros((0, seq_len), np.int32)}
    arr = np.asarray(stream[:n], np.int32).reshape(-1, seq_len)
    return {"tokens": arr}


def tokenize_and_pack(ds, *, seq_len: int, tokenizer: Optional[Any] = None,
                      text_column: str = "text"):
    """Dataset of text rows -> Dataset of ``{"tokens": int32[seq_len]}``.

    Documents are tokenized, concatenated within each block, and chopped
    into dense seq_len windows (the standard LM packing recipe: no padding
    waste; document boundaries are whatever the tokenizer emits, e.g.
    ByteTokenizer's BOS/EOS). The trailing partial window of each block is
    dropped — packing is per-block so the operation stays embarrassingly
    parallel over block tasks.
    """
    tok = tokenizer or ByteTokenizer()
    return ds.map_batches(functools.partial(_pack, seq_len=seq_len, tok=tok,
                                            text_column=text_column),
                          batch_size=None)
