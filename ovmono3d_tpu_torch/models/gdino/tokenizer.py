"""Self-contained BERT WordPiece tokenizer (no network, no transformers).

A copy of ovmono3d_tpu/models/gdino/tokenizer.py (pure Python; the port
imports nothing of the JAX package). The reference tokenizes captions with
HF AutoTokenizer('bert-base-uncased') (roi_heads_gdino.py:196-200); this is
BasicTokenizer + WordPiece written out: lowercasing, accent stripping,
punctuation splitting, greedy longest-match-first WordPiece with '##'
continuations, [CLS]/[SEP] wrapping. The standard `vocab.txt` ships with the
converted GroundingDINO checkpoint; a dict vocabulary serves tests and
seeded runs.
"""
from __future__ import annotations

import unicodedata
from pathlib import Path


class BertTokenizer:
    def __init__(self, vocab: dict[str, int] | str | Path):
        if not isinstance(vocab, dict):
            with open(vocab, encoding="utf-8") as f:
                vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        self.vocab = vocab
        self.unk = vocab.get("[UNK]", 100)
        self.cls_id = vocab.get("[CLS]", 101)
        self.sep_id = vocab.get("[SEP]", 102)
        self.pad_id = vocab.get("[PAD]", 0)
        self.period_id = vocab.get(".", 1012)
        self.question_id = vocab.get("?", 1029)

    # -- basic tokenization --------------------------------------------------

    @staticmethod
    def _is_punct(ch: str) -> bool:
        cp = ord(ch)
        if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (
            123 <= cp <= 126
        ):
            return True
        return unicodedata.category(ch).startswith("P")

    @staticmethod
    def _is_cjk(cp: int) -> bool:
        # BasicTokenizer._is_chinese_char ranges (bert-base tokenization).
        return (
            0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
        )

    def _basic(self, text: str) -> list[str]:
        # BasicTokenizer._clean_text: drop NUL/replacement/control chars,
        # map all whitespace to ' '; then _tokenize_chinese_chars: every
        # CJK ideograph becomes its own token.
        cleaned = []
        for ch in text:
            cp = ord(ch)
            if cp in (0, 0xFFFD) or (
                unicodedata.category(ch).startswith("C")
                and not ch.isspace()
            ):
                continue
            if self._is_cjk(cp):
                cleaned.append(" " + ch + " ")
            elif ch.isspace():
                cleaned.append(" ")
            else:
                cleaned.append(ch)
        text = "".join(cleaned)
        text = text.lower().strip()
        text = unicodedata.normalize("NFD", text)
        text = "".join(
            ch for ch in text if unicodedata.category(ch) != "Mn"
        )
        out: list[str] = []
        word = ""
        for ch in text:
            if ch.isspace():
                if word:
                    out.append(word)
                    word = ""
            elif self._is_punct(ch):
                if word:
                    out.append(word)
                    word = ""
                out.append(ch)
            else:
                word += ch
        if word:
            out.append(word)
        return out

    # WordpieceTokenizer default (bert-base-uncased).
    MAX_INPUT_CHARS_PER_WORD = 100

    def _wordpiece(self, word: str) -> list[int]:
        if len(word) > self.MAX_INPUT_CHARS_PER_WORD:
            return [self.unk]
        if word in self.vocab:
            return [self.vocab[word]]
        ids = []
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
            ids.append(cur)
            start = end
        return ids

    # -- public API -----------------------------------------------------------

    def tokenize_ids(self, text: str) -> list[int]:
        """Raw token ids without special tokens."""
        ids: list[int] = []
        for word in self._basic(text):
            ids.extend(self._wordpiece(word))
        return ids

    def encode(self, text: str, max_len: int = 256):
        """[CLS] ids [SEP], padded. Returns (ids list, valid length)."""
        ids = [self.cls_id] + self.tokenize_ids(text) + [self.sep_id]
        ids = ids[:max_len]
        n = len(ids)
        ids = ids + [self.pad_id] * (max_len - n)
        return ids, n


def build_caption(categories: list[str]) -> str:
    """The reference caption format: ' . '-joined lowercase names ending
    with ' .' (roi_heads_gdino.py:176-181)."""
    caption = " . ".join(c.lower().strip() for c in categories)
    if not caption.endswith("."):
        caption += " ."
    return caption


def phrase_token_spans(
    tok: BertTokenizer, categories: list[str], max_len: int = 256
) -> tuple[list[int], list[list[int]]]:
    """Token ids of the caption + per-category token index spans.

    Mirrors get_phrase_logits_from_token_logits (roi_heads_gdino.py:273-294):
    category i owns the token positions of its words inside the caption
    (between the '.' separators), offset by the leading [CLS].
    """
    ids = [tok.cls_id]
    spans: list[list[int]] = []
    for cat in categories:
        cat_ids = tok.tokenize_ids(cat.lower().strip())
        start = len(ids)
        ids.extend(cat_ids)
        spans.append(list(range(start, len(ids))))
        ids.append(tok.period_id)
    ids.append(tok.sep_id)
    if len(ids) > max_len:
        # The reference asserts on span mismatch rather than truncating
        # (roi_heads_gdino.py:284); silently clipping would zero the spans
        # of the overflowing categories and make them undetectable.
        raise ValueError(
            f"prompt needs {len(ids)} tokens for {len(categories)} "
            f"categories but max_text_len is {max_len}; split the category "
            "list across prompts"
        )
    return ids, spans
