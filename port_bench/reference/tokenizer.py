"""CLIP's byte-level BPE tokenizer (github.com/openai/CLIP
``clip/simple_tokenizer.py``, ``clip/clip.py`` ``tokenize``) for the plain
printable-ASCII prompts the benchmark sends: whitespace collapsed, lower
case, OpenAI's regular expression, the published merge table
(``assets/clip_bpe_merges.txt.gz``, the 16e6-sentence vocabulary), framed
by the start and end tokens and zero-padded to the context length."""

from __future__ import annotations

import functools
import gzip
import re
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

_MERGES = Path(__file__).resolve().parent / "assets" / "clip_bpe_merges.txt.gz"
# OpenAI's pattern with the Unicode letter and number classes written as the
# stdlib's: the two agree on ASCII text
_PATTERN = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                      r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+", re.IGNORECASE)


@functools.lru_cache(maxsize=1)
def _tables() -> Tuple[Dict[int, str], Dict[str, int], Dict[Tuple[str, str], int]]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    extra = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + extra)
            extra += 1
    byte_enc = dict(zip(bs, map(chr, cs)))
    with gzip.open(_MERGES, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    merges = [tuple(line.split()) for line in lines[1:49152 - 256 - 2 + 1]]
    vocab = list(byte_enc.values())
    vocab += [v + "</w>" for v in vocab]
    vocab += ["".join(m) for m in merges] + ["<|startoftext|>", "<|endoftext|>"]
    return byte_enc, {t: i for i, t in enumerate(vocab)}, {m: i for i, m in enumerate(merges)}


def _bpe(token: str, ranks) -> List[str]:
    word = list(token[:-1]) + [token[-1] + "</w>"]
    while len(word) > 1:
        pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
        best = min(pairs, key=lambda p: ranks.get(p, float("inf")))
        if best not in ranks:
            break
        merged, i = [], 0
        while i < len(word):
            if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                merged.append(word[i] + word[i + 1])
                i += 2
            else:
                merged.append(word[i])
                i += 1
        word = merged
    return word


def tokenize(texts: List[str], context_length: int = 77) -> np.ndarray:
    """[len(texts), context_length] int64 token ids."""
    byte_enc, encoder, ranks = _tables()
    out = np.zeros((len(texts), context_length), dtype=np.int64)
    for row, text in enumerate(texts):
        if not text.isascii():
            raise ValueError(f"the reference tokenizer takes ASCII prompts: {text!r}")
        text = re.sub(r"\s+", " ", text).strip().lower()
        ids = [encoder["<|startoftext|>"]]
        for piece in _PATTERN.findall(text):
            ids += [encoder[t] for t in _bpe("".join(byte_enc[b] for b in piece.encode()), ranks)]
        ids.append(encoder["<|endoftext|>"])
        if len(ids) > context_length:
            raise ValueError(f"prompt longer than {context_length} tokens: {text!r}")
        out[row, :len(ids)] = ids
    return out
