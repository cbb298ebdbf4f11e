"""Qwen2 ChatML prompt template (the copy of
``ufvideo_tpu/conversation.py apply_chat_template`` that ``mm_infer`` uses)."""

from __future__ import annotations

from typing import Sequence

DEFAULT_SYSTEM = "You are a helpful assistant."


def apply_chat_template(
    messages: Sequence[dict], add_generation_prompt: bool = True
) -> str:
    """ChatML prompt; inserts the default system turn when none is given."""
    out = []
    if not messages or messages[0].get("role") != "system":
        out.append(f"<|im_start|>system\n{DEFAULT_SYSTEM}<|im_end|>\n")
    for m in messages:
        out.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
    return "".join(out)
