"""The prompt of a video question as token ids: the ChatML template with the
default system turn, the question after the ``<video>`` tag, encoded one
token a UTF-8 byte with the control tokens after the 256 byte ids (the
offline byte tokenizer's vocabulary). The ``<video>`` tag stands for the
video tokens: ``VIDEO`` marks where they are spliced in. A frozen copy of
the formulas, so the reference works out the splice positions itself."""

from __future__ import annotations

from typing import List

SYSTEM = "You are a helpful assistant."
VIDEO = -201  # the splice sentinel
SPECIAL = {"<|endoftext|>": 256, "<|im_start|>": 257, "<|im_end|>": 258}


def _encode(text: str) -> List[int]:
    """Bytes, with the three control tokens taken whole."""
    ids: List[int] = []
    i = 0
    while i < len(text):
        for tok, tid in SPECIAL.items():
            if text.startswith(tok, i):
                ids.append(tid)
                i += len(tok)
                break
        else:
            j = min((text.find(t, i) for t in SPECIAL if text.find(t, i) >= 0),
                    default=len(text))
            ids.extend(text[i:j].encode("utf-8"))
            i = j
    return ids


def prompt_ids(question: str) -> List[int]:
    """Token ids of one video question, ``VIDEO`` at the video's place."""
    before = f"<|im_start|>system\n{SYSTEM}<|im_end|>\n<|im_start|>user\n"
    after = f"\n{question}<|im_end|>\n<|im_start|>assistant\n"
    return _encode(before) + [VIDEO] + _encode(after)


def spliced_length(question: str, video_tokens: int) -> int:
    """Positions of the prompt once the video tokens are in."""
    return len(prompt_ids(question)) - 1 + video_tokens
