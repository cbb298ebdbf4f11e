"""Multimodal tokenization and stop-string trimming (copies of
``ufvideo_tpu/mm_utils.py`` ``tokenizer_multimodal_token`` and
``trim_at_stop_strings``)."""

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
