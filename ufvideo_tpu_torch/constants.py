"""Token conventions and frame budgets the port needs (a copy of the parts
of ``ufvideo_tpu/constants.py`` it uses: same sentinel ids, same
special-token order, so prompts tokenize identically in both packages)."""

IGNORE_INDEX = -100

# Modal sentinel ids, interleaved into input_ids by the multimodal tokenizer.
IMAGE_TOKEN_INDEX = -200
VIDEO_TOKEN_INDEX = -201
AUDIO_TOKEN_INDEX = -202

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_VIDEO_TOKEN = "<video>"
DEFAULT_AUDIO_TOKEN = "<audio>"

MODAL_INDEX_MAP = {
    "<image>": IMAGE_TOKEN_INDEX,
    "<video>": VIDEO_TOKEN_INDEX,
    "<audio>": AUDIO_TOKEN_INDEX,
}

# Frame budgets of the host video loaders (``mm_utils.load_frames``).
NUM_FRAMES = 32
NUM_FRAMES_PER_SECOND = 1

TEMPORAL_TOKEN_FORMAT = "<TEMP-{:03d}>"
NUM_TEMPORAL_TOKENS = 100

REGION_TOKEN = "<region>"
SEG_TOKEN = "[SEG]"


def temporal_tokens() -> list:
    """The 100 ``<TEMP-000>..<TEMP-099>`` temporal grounding tokens."""
    return [TEMPORAL_TOKEN_FORMAT.format(i) for i in range(NUM_TEMPORAL_TOKENS)]


def extra_special_tokens() -> list:
    """Tokens added on top of the base LLM vocabulary, in order: <region>,
    the 100 temporal tokens, then [SEG]."""
    return [REGION_TOKEN, *temporal_tokens(), SEG_TOKEN]

# templated classic-segmentation prompts (the training data pipeline)
QUESTION_LIST = [
    "Can you segment the {class_name} in this image?",
    "Please segment the {class_name} in this image.",
    "What is {class_name} in this image? Please respond with segmentation mask.",
    "What is {class_name} in this image? Please output segmentation mask.",
]

ANSWER_LIST = [
    "It is [SEG].",
    "Sure, [SEG].",
    "Sure, it is [SEG].",
    "Sure, the segmentation result is [SEG].",
    "[SEG].",
]
