"""Conversation prompt templates (a copy of ``ufvideo_tpu/conversation.py``):
``Conversation`` with its separator styles and the ``conv_templates``
registry of the reference's prompt templates, and the Qwen2 ChatML
``apply_chat_template`` that ``mm_infer`` uses."""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import List, Sequence, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    PLAIN = auto()
    LLAMA2 = auto()
    QWEN = auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[str]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str = ""
    version: str = "Unknown"
    modality: str = "image"

    def get_prompt(self) -> str:
        messages = self.messages
        modality_token = f"<{self.modality}>"
        if messages and isinstance(messages[0][1], tuple):
            messages = [list(m) for m in self.messages]
            init_role, init_msg = messages[0]
            init_msg = init_msg[0].replace(modality_token, "").strip()
            messages[0] = [init_role, f"{modality_token}\n" + init_msg]

        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
            return ret

        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret

        if self.sep_style == SeparatorStyle.QWEN:
            # ChatML (conversation.py:88-104): system + <|im_end|>\n, then
            # "<|im_start|>role\n" + msg + "<|im_end|>\n"; a trailing bare
            # role opens the generation turn.
            ret = self.system + self.sep + "\n"
            for i, (role, message) in enumerate(messages):
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += role + message + self.sep + "\n"
                else:
                    ret += role
            return ret

        if self.sep_style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += role + message + seps[i % 2]
                else:
                    ret += role
            return ret

        if self.sep_style == SeparatorStyle.LLAMA2:
            # system is always wrapped into the first (user) message
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n"

            def wrap_inst(msg):
                return f"[INST] {msg} [/INST]"

            ret = ""
            for i, (role, message) in enumerate(messages):
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        ret += self.sep + wrap_inst(message)
                    else:
                        ret += " " + message + " " + self.sep2
                else:
                    ret += ""
            return ret.lstrip(self.sep)

        raise ValueError(f"Invalid style: {self.sep_style}")

    def append_message(self, role: str, message) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[list(m) for m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
            modality=self.modality,
        )


conv_qwen = Conversation(
    system="<|im_start|>system\nYou are a helpful assistant.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    messages=[],
    sep_style=SeparatorStyle.QWEN,
    sep="<|im_end|>",
    version="qwen",
)

conv_qwen_plain = Conversation(
    system="",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    messages=[],
    sep_style=SeparatorStyle.PLAIN,
    sep="<|im_end|>",
    sep2="<|im_end|>",
    version="qwen_plain",
)

conv_vicuna_v1 = Conversation(
    system=(
        "A chat between a curious user and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_llama2 = Conversation(
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA2,
    sep="<s>",
    sep2="</s>",
    version="llama2",
)

conv_llava_v1 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the human's questions."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_llava_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    sep_style=SeparatorStyle.PLAIN,
    sep="",
    sep2="\n",
)

conv_vicuna_v0 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    messages=[
        ["Human", "What are the key differences between renewable and non-renewable energy sources?"],
        ["Assistant",
         "Renewable energy sources are those that can be replenished naturally in a relatively "
         "short amount of time, such as solar, wind, hydro, geothermal, and biomass. "
         "Non-renewable energy sources, on the other hand, are finite and will eventually be "
         "depleted, such as coal, oil, and natural gas. Here are some key differences between "
         "renewable and non-renewable energy sources:\n"
         "1. Availability: Renewable energy sources are virtually inexhaustible, while non-renewable "
         "energy sources are finite and will eventually run out.\n"
         "2. Environmental impact: Renewable energy sources have a much lower environmental impact "
         "than non-renewable sources, which can lead to air and water pollution, greenhouse gas emissions, "
         "and other negative effects.\n"
         "3. Cost: Renewable energy sources can be more expensive to initially set up, but they typically "
         "have lower operational costs than non-renewable sources.\n"
         "4. Reliability: Renewable energy sources are often more reliable and can be used in more remote "
         "locations than non-renewable sources.\n"
         "5. Flexibility: Renewable energy sources are often more flexible and can be adapted to different "
         "situations and needs, while non-renewable sources are more rigid and inflexible.\n"
         "6. Sustainability: Renewable energy sources are more sustainable over the long term, while "
         "non-renewable sources are not, and their depletion can lead to economic and social instability.\n"],
    ],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_mistral = Conversation(
    system=(
        "A chat between a curious user and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA2,
    sep="",
    sep2="</s>",
    version="llama2",
)

conv_templates = {
    "qwen": conv_qwen,
    "qwen_plain": conv_qwen_plain,
    # reference registry keys (conversation.py:480-505); "plain" is the
    # LLaVA pretrain template, "default" the seeded vicuna v0
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llava_v1": conv_llava_v1,
    "llama2": conv_llama2,
    "mistral": conv_mistral,
}

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
