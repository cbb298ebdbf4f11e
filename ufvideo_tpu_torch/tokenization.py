"""Tokenizers (mirrors ``ufvideo_tpu/tokenization.py``): an HF tokenizer
extended with the UFVideo special tokens (``extend_tokenizer``,
``load_tokenizer``; ``transformers`` is imported only there, and the card's
machine has none), the offline byte-level tokenizer (``ByteTokenizer`` /
``SpecialIds`` / ``byte_tokenizer_with_ids``: same vocabulary, same ids),
and ``parse_temporal_tokens``, which reads temporal grounding out of
generated text."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Sequence

from .constants import NUM_TEMPORAL_TOKENS, extra_special_tokens


@dataclass
class SpecialIds:
    region: int
    temporal_start: int  # <TEMP-000>; <TEMP-k> = temporal_start + k
    seg: int
    eos: int
    pad: int


def extend_tokenizer(tokenizer) -> SpecialIds:
    """Add the UFVideo special tokens to an HF tokenizer, in the reference's
    order (``<region>``, the 100 ``<TEMP-xxx>``, ``[SEG]``), and return
    their ids; the pad id falls back to the eos id."""
    tokenizer.add_tokens(extra_special_tokens(), special_tokens=True)
    ids = tokenizer.convert_tokens_to_ids(extra_special_tokens())
    eos = tokenizer.eos_token_id
    pad = tokenizer.pad_token_id
    return SpecialIds(region=ids[0], temporal_start=ids[1], seg=ids[-1], eos=eos,
                      pad=eos if pad is None else pad)


def load_tokenizer(path: str):
    """An HF tokenizer directory, extended: (tokenizer, SpecialIds). Needs
    the ``transformers`` package; without it this raises, and the caller
    that wants the offline byte tokenizer asks for it
    (``byte_tokenizer_with_ids``)."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            "load_tokenizer needs the 'transformers' package (HF tokenizers), which this "
            "machine lacks; without tokenizer_path model_init uses the byte tokenizer"
        ) from e
    tok = AutoTokenizer.from_pretrained(path)
    return tok, extend_tokenizer(tok)


class _Encoding:
    def __init__(self, input_ids):
        self.input_ids = input_ids


class ByteTokenizer:
    """256 byte ids, then the ChatML control tokens and the UFVideo
    special tokens."""

    BASE = 256

    def __init__(self):
        self.specials: List[str] = [
            "<|endoftext|>", "<|im_start|>", "<|im_end|>",
        ] + extra_special_tokens()
        self._sp_id = {s: self.BASE + i for i, s in enumerate(self.specials)}
        self.eos_token = "<|im_end|>"
        self.eos_token_id = self._sp_id["<|im_end|>"]
        self.pad_token = "<|endoftext|>"
        self.pad_token_id = self._sp_id["<|endoftext|>"]

    def __len__(self):
        return self.BASE + len(self.specials)

    @property
    def vocab_size(self):
        return len(self)

    def _split_specials(self, text: str) -> List[str]:
        parts = [text]
        for s in self.specials:
            nxt = []
            for p in parts:
                if p in self._sp_id:
                    nxt.append(p)
                    continue
                chunks = p.split(s)
                for i, c in enumerate(chunks):
                    if i:
                        nxt.append(s)
                    if c:
                        nxt.append(c)
            parts = nxt
        return parts

    def __call__(self, text: str, add_special_tokens: bool = False) -> _Encoding:
        ids: List[int] = []
        for part in self._split_specials(text):
            if part in self._sp_id:
                ids.append(self._sp_id[part])
            else:
                ids.extend(part.encode("utf-8"))
        return _Encoding(ids)

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self._sp_id.get(tokens, -1)
        return [self._sp_id.get(t, -1) for t in tokens]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out: List[str] = []
        buf: List[int] = []

        def flush():
            if buf:
                out.append(bytes(buf).decode("utf-8", errors="replace"))
                buf.clear()

        for i in ids:
            i = int(i)
            if i < self.BASE:
                buf.append(i)
            else:
                flush()
                if not skip_special_tokens and i - self.BASE < len(self.specials):
                    out.append(self.specials[i - self.BASE])
        flush()
        return "".join(out)

    def apply_chat_template(self, messages, tokenize=False, add_generation_prompt=True):
        from .conversation import apply_chat_template

        if tokenize:
            raise ValueError("ByteTokenizer.apply_chat_template returns text only")
        return apply_chat_template(messages, add_generation_prompt)


def byte_tokenizer_with_ids():
    tok = ByteTokenizer()
    ids = SpecialIds(
        region=tok.convert_tokens_to_ids("<region>"),
        temporal_start=tok.convert_tokens_to_ids("<TEMP-000>"),
        seg=tok.convert_tokens_to_ids("[SEG]"),
        eos=tok.eos_token_id,
        pad=tok.pad_token_id,
    )
    return tok, ids


def parse_temporal_tokens(text: str) -> List[float]:
    """Normalised timestamps of the ``<TEMP-xxx>`` tokens in generated text."""
    return [int(m) / (NUM_TEMPORAL_TOKENS - 1) for m in re.findall(r"<TEMP-(\d{3})>", text)]
