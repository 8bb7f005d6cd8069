"""CLIP byte-level BPE tokenizer (the port's own copy of
coin_tpu/models/tokenizer.py:22-130).

The CLIP tokenization scheme (OpenAI's SimpleTokenizer): byte-level BPE
over the merges of the standard vocabulary file
(``bpe_simple_vocab_16e6.txt.gz``), a data asset the user supplies, like
the CLIP weights; pass its path to the constructor. The word regex keeps
the JAX package's ASCII approximation of ``\\p{L}`` / ``\\p{N}``, so that
both packages give the same token ids.
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte → printable-unicode mapping (GPT-2 convention)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    CONTEXT_LENGTH = 77

    def __init__(self, bpe_path: str):
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        # \p{L}/\p{N} classes approximated with ASCII ranges (class names
        # in the supported datasets are ASCII)
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(token).split(
                " "))
        return tokens

    def tokenize(self, texts: Union[str, Sequence[str]],
                 context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """(N, context_length) int32 — SOT + tokens + EOT + zero padding
        (clip_text.py:341-361 semantics, errors on overflow)."""
        if isinstance(texts, str):
            texts = [texts]
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            toks = [sot] + self.encode(text) + [eot]
            if len(toks) > context_length:
                raise RuntimeError(
                    f"input too long for context {context_length}: {text}")
            out[i, :len(toks)] = toks
        return out


def write_bpe_merges(path: str, words: Sequence[str]) -> None:
    """Write a small gzipped merges file in the vocabulary file's format (a
    header line, then one merge per line) whose merges build each of
    ``words`` (lower-cased) from its letters, left to right, the last
    letter with the '</w>' mark. Any other word tokenizes into bytes. It
    stands in for the real vocabulary in tests and rehearsals."""
    merges: List[str] = []
    for word in dict.fromkeys(w.lower() for w in words):
        if len(word) < 2:
            continue
        head = word[0]
        for i, ch in enumerate(word[1:], 1):
            tail = ch + "</w>" if i == len(word) - 1 else ch
            merges.append(f"{head} {tail}")
            head += tail
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(dict.fromkeys(merges)) + "\n")
