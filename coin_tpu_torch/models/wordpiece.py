"""Minimal BERT WordPiece tokenizer (uncased), reading a standard
``vocab.txt``. Replaces the HF AutoTokenizer dependency of the reference's
GDINO wrapper without hub access — the vocab file ships alongside the BERT
weights the user supplies."""

from __future__ import annotations

import unicodedata
from typing import Dict, List


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    def __init__(self, vocab_path: str, lowercase: bool = True):
        self.vocab: Dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.lowercase = lowercase
        self.cls = self.vocab["[CLS]"]
        self.sep = self.vocab["[SEP]"]
        self.pad = self.vocab.get("[PAD]", 0)
        self.unk = self.vocab["[UNK]"]

    def _basic(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
        out: List[str] = []
        word = ""
        for ch in text:
            if ch.isspace():
                if word:
                    out.append(word)
                    word = ""
            elif _is_punct(ch):
                if word:
                    out.append(word)
                    word = ""
                out.append(ch)
            else:
                word += ch
        if word:
            out.append(word)
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        tokens: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            tokens.append(cur)
            start = end
        return tokens

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for w in self._basic(text):
            ids.extend(self._wordpiece(w))
        return ids

    def __call__(self, text: str, max_len: int = 256):
        """Returns (ids, mask) numpy-friendly lists padded to max_len."""
        ids = [self.cls] + self.encode(text)[:max_len - 2] + [self.sep]
        mask = [1] * len(ids)
        while len(ids) < max_len:
            ids.append(self.pad)
            mask.append(0)
        return ids, mask
