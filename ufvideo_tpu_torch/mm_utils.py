"""Multimodal tokenization, stop-string trimming and streamed text deltas
(copies of ``ufvideo_tpu/mm_utils.py`` ``tokenizer_multimodal_token``,
``trim_at_stop_strings`` and ``TextDeltaStreamer``)."""

from __future__ import annotations

from typing import List, Sequence

from .constants import MODAL_INDEX_MAP


def tokenizer_multimodal_token(
    prompt: str, tokenizer, multimodal_token: str = "<image>"
) -> List[int]:
    """Split on the modal tag and interleave its negative sentinel id."""
    idx = MODAL_INDEX_MAP.get(multimodal_token)
    if idx is None:
        return tokenizer(prompt, add_special_tokens=False).input_ids
    chunks = [
        tokenizer(c, add_special_tokens=False).input_ids
        for c in prompt.split(multimodal_token)
    ]
    input_ids: List[int] = []
    for i in range(1, 2 * len(chunks)):
        if i % 2 == 1:
            input_ids.extend(chunks[i // 2])
        else:
            input_ids.append(idx)
    return input_ids


def trim_at_stop_strings(text: str, keywords: Sequence[str]) -> str:
    """Cut ``text`` at the earliest occurrence of any keyword."""
    cut = len(text)
    for kw in keywords:
        pos = text.find(kw)
        if pos != -1:
            cut = min(cut, pos)
    return text[:cut]


class TextDeltaStreamer:
    """Token ids pushed a chunk at a time → text deltas whose join equals the
    one-shot (stop-trimmed) decode.

    Cumulative decoding is append-only but for two hazards, both removed by
    holding an unemitted tail back:

    - a multi-byte character split across chunks decodes to a trailing
      U+FFFD that the next chunk rewrites: trailing replacement characters
      are never emitted before ``finish``;
    - a stop string spanning a chunk boundary would stream its prefix: the
      last ``len(longest stop) - 1`` characters are reserved, so a stop can
      only begin inside unemitted text.

    ``push(ids) -> (delta, stopped)`` per chunk; ``finish() -> delta``
    flushes the held tail when generation ends."""

    def __init__(self, tokenizer, stop_strings: Sequence[str] = ()):
        self._tok = tokenizer
        self._stops = [s for s in (stop_strings or []) if s]
        self._reserve = max((len(s) for s in self._stops), default=1) - 1
        self._ids: list = []
        self._sent = 0  # characters already emitted
        self.stopped = False

    def _decode(self) -> str:
        return self._tok.decode(self._ids, skip_special_tokens=True)

    def push(self, new_ids: Sequence[int]):
        self._ids.extend(int(i) for i in new_ids)
        text = self._decode()
        if self._stops and any(s in text for s in self._stops):
            text = trim_at_stop_strings(text, self._stops)
            self.stopped = True
            delta = text[self._sent:]
            self._sent = len(text)
            return delta, True
        end = len(text)
        while end > 0 and text[end - 1] == "\ufffd":
            end -= 1
        safe = max(self._sent, min(end, len(text) - self._reserve))
        delta = text[self._sent:safe]
        self._sent = safe
        return delta, False

    def finish(self) -> str:
        """The held tail (a trailing U+FFFD of generation that really ends
        mid-character is emitted here: the one-shot decode holds it too)."""
        text = self._decode()
        if self._stops and any(s in text for s in self._stops):
            text = trim_at_stop_strings(text, self._stops)
            self.stopped = True
        delta = text[self._sent:]
        self._sent = len(text)
        return delta

    def text(self) -> str:
        """The whole (stop-trimmed) text so far."""
        text = self._decode()
        if self._stops and any(s in text for s in self._stops):
            text = trim_at_stop_strings(text, self._stops)
        return text

    @property
    def ids(self) -> list:
        """Every token id pushed so far."""
        return list(self._ids)
