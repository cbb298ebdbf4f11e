"""The port's ``conversation.py`` against ``ufvideo_tpu.conversation``: every
``conv_templates`` entry's ``get_prompt`` byte for byte after 1-3 turns, with
and without a trailing ``None`` (the open generation turn), with an
``(text, image)`` tuple as the first message, and the registry, the copy and
``apply_chat_template`` themselves."""

import pytest

from ufvideo_tpu import conversation as jc
from ufvideo_tpu_torch import conversation as pc

TURNS = [
    ("<video>\nWhat is the object <region> doing?", "It is running. [SEG]"),
    ("And after that?", "It stops near the <region>.\nThen it turns left."),
    ("Where is it at the end?", "Near the door: {<TEMP-012>, <TEMP-031>}."),
]


def _fill(conv, n_turns: int, trailing_none: bool, tuple_first: bool = False):
    for i, (q, a) in enumerate(TURNS[:n_turns]):
        if i == 0 and tuple_first:
            q = (q.replace("<video>\n", "") + " <image>", "an image", "Default")
        conv.append_message(conv.roles[0], q)
        if i < n_turns - 1 or not trailing_none:
            conv.append_message(conv.roles[1], a)
        else:
            conv.append_message(conv.roles[1], None)
    return conv


@pytest.mark.parametrize("key", sorted(jc.conv_templates))
@pytest.mark.parametrize("n_turns", [1, 2, 3])
@pytest.mark.parametrize("trailing_none", [False, True], ids=["answered", "open"])
def test_get_prompt_equals_jax(key, n_turns, trailing_none):
    got = _fill(pc.conv_templates[key].copy(), n_turns, trailing_none).get_prompt()
    want = _fill(jc.conv_templates[key].copy(), n_turns, trailing_none).get_prompt()
    assert got.encode() == want.encode()


@pytest.mark.parametrize("key", sorted(jc.conv_templates))
def test_tuple_first_message_equals_jax(key):
    """A first message given as (text, image, mode): its modality token moved
    to the front, as the JAX ``get_prompt`` does."""
    got = _fill(pc.conv_templates[key].copy(), 2, True, tuple_first=True).get_prompt()
    want = _fill(jc.conv_templates[key].copy(), 2, True, tuple_first=True).get_prompt()
    assert got.encode() == want.encode()


def test_registry_styles_and_copy():
    assert sorted(pc.conv_templates) == sorted(jc.conv_templates)
    assert [s.name for s in pc.SeparatorStyle] == [s.name for s in jc.SeparatorStyle]
    for key, conv in pc.conv_templates.items():
        ref = jc.conv_templates[key]
        for f in ("system", "roles", "messages", "offset", "sep", "sep2", "version",
                  "modality"):
            assert getattr(conv, f) == getattr(ref, f), (key, f)
        assert conv.sep_style.name == ref.sep_style.name
    base = pc.conv_templates["qwen"]
    c = base.copy()
    c.append_message(c.roles[0], "hi")
    assert base.messages == [] and c.messages == [[c.roles[0], "hi"]]
    with pytest.raises(ValueError, match="Invalid style"):
        pc.Conversation(system="", roles=("a", "b"), messages=[], sep_style=None).get_prompt()


@pytest.mark.parametrize("with_system", [False, True])
def test_apply_chat_template_equals_jax(with_system):
    msgs = [{"role": "user", "content": "<video>\nWhat happens?"},
            {"role": "assistant", "content": "A dog runs."},
            {"role": "user", "content": "Then?"}]
    if with_system:
        msgs.insert(0, {"role": "system", "content": "Be brief."})
    for gen in (True, False):
        assert pc.apply_chat_template(msgs, gen) == jc.apply_chat_template(msgs, gen)
