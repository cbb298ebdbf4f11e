"""Public inference API: ``model_init`` and ``mm_infer`` (mirrors
``ufvideo_tpu/api.py``: video / image / text QA, region referring through
``masks`` / ``frame`` / ``ann_indices`` and ``<region>`` placeholders, and
``[SEG]`` video segmentation through SAM2, whether the model generates the
``[SEG]`` token or finds it in the input).

Entry points run on the card by default: ``model_init(device="cuda")``
raises when CUDA is missing, and the caller passes ``device="cpu"`` to run
on the CPU (the plain versions of the kernels). The config's ``quant_llm``
(int8 / int4 weight-only LM), ``quant_kv`` (int8 KV cache) and
``quant_vision`` (W8A8 SigLIP tower and W8A8 Hiera trunk of SAM2) build the
quantised runtime, ``spec_decode`` (prompt-lookup speculation, greedy
decoding only) and ``prefill_chunk`` (prefill that many sequences at a time)
the serving options of ``UFVideoRuntime.generate_batch``.
``UFVideoRuntime.segment_videos_batched`` segments several videos in one
walk over their frames. ``mm_infer_stream`` yields text deltas as decode
chunks complete; ``mm_infer_batch`` serves several requests in one
encode, one generate and one SAM2 propagation. Checkpoint loading comes
with a later slice and raises ``NotImplementedError`` naming its ROADMAP.md
item.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .configs import UFVideoConfig, VisionRouting
from .constants import DEFAULT_IMAGE_TOKEN, DEFAULT_VIDEO_TOKEN
from .mm_utils import TextDeltaStreamer, tokenizer_multimodal_token, trim_at_stop_strings
from .models.generate import forward_hidden, greedy_generate, stream_generate
from .models.region_encoder import resize_mask_to_grid_np
from .models.sam2.video import (
    encode_video_frames,
    masks_to_video_res,
    propagate_video,
    propagate_videos_batched,
)
from .models.speculative import spec_generate, spec_stream_generate
from .models.ufvideo import UFVideoModel
from .splicing import plan_lookup_ids, plan_splice
from .tokenization import SpecialIds, byte_tokenizer_with_ids


class UFVideoRuntime:
    """Owns the composite model, its config, token ids and device."""

    def __init__(self, cfg: UFVideoConfig, model: UFVideoModel, ids: SpecialIds,
                 device: torch.device):
        self.cfg = cfg
        self.model = model
        self.ids = ids
        self.device = torch.device(device)

    def encode_video(self, pixels) -> torch.Tensor:
        """[B, T, H, W, 3] SigLIP-preprocessed frames → video tokens."""
        return self.model.encode_video(torch.as_tensor(pixels, device=self.device))

    @torch.no_grad()
    def pack_and_encode_regions(
        self,
        frame_pixels,  # [F, H, W, 3] annotated frames: SigLIP-preprocessed floats or raw uint8
        masks,  # [F, Hm, Wm] binary masks, one per annotated frame
        ann_indices: Optional[Sequence[Sequence[int]]],  # frames of each region
    ):
        """(frame, masks, ann_indices) → (region tokens [1, R·rt, hidden],
        the merged-token count of each region). ``ann_indices=None`` means
        one region per annotated frame. Masks are resized to the patch grid
        on the host, and the frame and region counts are padded to powers of
        two with validity masks, as the JAX runtime does.

        Deviation from the JAX package: a raw uint8 ``frame_pixels`` is
        resized and normalised on the device (``siglip_preprocess_device``),
        as uint8 video frames are in both packages. The JAX runtime copies
        uint8 annotated frames into float32 unchanged and encodes the 0-255
        values at whatever size they come; fed this method's preprocessed
        frames, it gives the same region tokens."""
        cfg = self.cfg
        rt = cfg.region.region_token_num
        # masks are resized to the patch grid on the host, as in JAX
        masks = masks.detach().cpu().numpy() if torch.is_tensor(masks) else np.asarray(masks)
        if ann_indices is None:
            ann_indices = [[i] for i in range(len(masks))]
        grid = cfg.vision.image_size // cfg.vision.patch_size
        pow2 = lambda n: 1 << max(n - 1, 0).bit_length()
        pixels = _on_device(frame_pixels, self.device)
        if pixels.dtype == torch.uint8:
            from .ops.image_pipeline import siglip_preprocess_device

            pixels = siglip_preprocess_device(pixels, out_dtype=torch.float32)
        n_frames = pixels.shape[0]
        f_budget = pow2(max(n_frames, 1))
        r_budget = pow2(max(len(ann_indices), 1))
        fp = torch.zeros((1, f_budget) + tuple(pixels.shape[1:]), dtype=torch.float32,
                         device=self.device)
        fp[0, :n_frames] = pixels
        mk = np.zeros((1, f_budget, grid, grid), np.float32)
        mk[0, :len(masks)] = resize_mask_to_grid_np(masks, grid)
        fv = np.zeros((1, f_budget), bool)
        fv[0, :n_frames] = True
        seg = np.zeros((1, r_budget, f_budget), bool)
        for r, idxs in enumerate(ann_indices):
            seg[0, r, list(idxs)] = True
        on_dev = lambda a: torch.from_numpy(a).to(self.device)
        feats, _ = self.model.encode_regions(fp, on_dev(mk), on_dev(fv), on_dev(seg))
        return feats, [min(len(idxs), rt) for idxs in ann_indices]

    def _splice_plan(self, input_ids_list, video_feats, region_feats=None,
                     region_counts_list=None):
        """Splice plan + spliced input embeddings for a batch of id lists."""
        cfg = self.cfg
        plan = plan_splice(
            list(input_ids_list),
            num_video_tokens=video_feats.shape[1] if video_feats is not None else 0,
            region_token_counts=[
                (region_counts_list[i] if region_counts_list else []) or []
                for i in range(len(input_ids_list))
            ],
            region_token_id=self.ids.region,
            max_seq_len=cfg.budget.max_seq_len,
            region_stride=cfg.region.region_token_num,
        )
        dev = self.device
        embeds = self.model.splice_embeds(
            torch.as_tensor(plan.text_ids, device=dev),
            torch.as_tensor(plan.src_kind, device=dev),
            torch.as_tensor(plan.src_idx, device=dev),
            video_feats,
            region_feats,
        )
        # run only up to the 256-rounded true length, not the budget
        real_len = int(max(plan.seq_lens))
        trim = min((real_len + 255) // 256 * 256, cfg.budget.max_seq_len)
        return plan, embeds[:, :trim]

    def generate(
        self,
        input_ids: List[int],
        video_feats: Optional[torch.Tensor],
        region_feats: Optional[torch.Tensor] = None,
        region_token_counts: Optional[List[int]] = None,
        max_new_tokens: int = 128,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_p: float = 1.0,
        seed: int = 0,
        stop_sequences: tuple = (),
    ):
        """Decode one sample. Returns (generated ids, hidden states of the
        steps that produced them [N, hidden], splice plan)."""
        out, plan = self.generate_batch(
            [input_ids], video_feats, region_feats, [region_token_counts or []],
            max_new_tokens=max_new_tokens,
            do_sample=do_sample, temperature=temperature, top_p=top_p,
            seed=seed, stop_sequences=stop_sequences,
        )
        tokens, hidden = out[0]
        return tokens, hidden, plan

    @torch.no_grad()
    def generate_batch(
        self,
        input_ids_list: Sequence[List[int]],
        video_feats: Optional[torch.Tensor],  # [B, V, D] or None
        region_feats: Optional[torch.Tensor] = None,  # [B, RT, D]
        region_counts_list: Optional[Sequence[List[int]]] = None,
        max_new_tokens: int = 128,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_p: float = 1.0,
        seed: int = 0,
        stop_sequences: tuple = (),
    ):
        """Decode B samples together. Returns a list of (ids, hidden
        [N, hidden]) per sample, plus the shared splice plan. With
        ``cfg.spec_decode`` = K, greedy decoding without multi-token stops
        runs prompt-lookup speculation with K drafts (the same tokens);
        ``cfg.prefill_chunk`` prefills that many samples at a time."""
        cfg = self.cfg
        b = len(input_ids_list)
        dev = self.device
        plan, embeds = self._splice_plan(
            input_ids_list, video_feats, region_feats, region_counts_list)
        trim = embeds.shape[1]
        lens = torch.as_tensor(plan.seq_lens, device=dev)
        spec_k = int(cfg.spec_decode or 0)
        if spec_k and not do_sample and not stop_sequences:
            res = spec_generate(
                self.model.llm, embeds, lens,
                torch.as_tensor(plan_lookup_ids(plan)[:, :trim], device=dev),
                max_new_tokens=max_new_tokens,
                stop_ids=(self.ids.eos,),
                cache_max_len=trim + max_new_tokens + spec_k,
                draft_k=spec_k,
                vocab_size=cfg.llm.vocab_size,
                kv_quant=bool(cfg.quant_kv),
                prefill_chunk=cfg.prefill_chunk,
            ).as_generate_result()
        else:
            res = greedy_generate(
                self.model.llm,
                embeds,
                lens,
                max_new_tokens=max_new_tokens,
                stop_ids=(self.ids.eos,),
                cache_max_len=trim + max_new_tokens,
                vocab_size=cfg.llm.vocab_size,
                do_sample=do_sample,
                temperature=temperature,
                top_p=top_p,
                generator=self._generator(do_sample, seed),
                stop_sequences=tuple(tuple(s) for s in stop_sequences),
                kv_quant=bool(cfg.quant_kv),
                prefill_chunk=cfg.prefill_chunk,
            )
        gen_lens = res.gen_lens.tolist()
        tokens = res.tokens.tolist()
        out = [(tokens[i][: gen_lens[i]], res.hidden[i, : gen_lens[i]]) for i in range(b)]
        return out, plan

    def _generator(self, do_sample: bool, seed: int) -> Optional[torch.Generator]:
        if not do_sample:
            return None
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        return generator

    @torch.no_grad()
    def generate_stream(
        self,
        input_ids: List[int],
        video_feats: Optional[torch.Tensor],
        region_feats: Optional[torch.Tensor] = None,
        region_token_counts: Optional[List[int]] = None,
        max_new_tokens: int = 128,
        chunk: int = 16,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_p: float = 1.0,
        seed: int = 0,
    ):
        """Streaming decode of one sample: yields ``(ids, hiddens [n,
        hidden])`` after the prefill and after each ``chunk`` decode steps,
        the same tokens as ``generate`` under the same seed. With
        ``cfg.spec_decode`` set and greedy decoding, each yield is one
        draft → verify iteration's 1 to K + 1 tokens."""
        cfg = self.cfg
        dev = self.device
        plan, embeds = self._splice_plan(
            [list(input_ids)], video_feats, region_feats, [region_token_counts or []])
        trim = embeds.shape[1]
        lens = torch.as_tensor(plan.seq_lens, device=dev)
        spec_k = int(cfg.spec_decode or 0)
        if spec_k and not do_sample:
            prev = 0
            for tokens, gen_lens, hiddens, done in spec_stream_generate(
                self.model.llm, embeds, lens,
                torch.as_tensor(plan_lookup_ids(plan)[:, :trim], device=dev),
                max_new_tokens=max_new_tokens,
                stop_ids=(self.ids.eos,),
                cache_max_len=trim + max_new_tokens + spec_k,
                draft_k=spec_k,
                vocab_size=cfg.llm.vocab_size,
                kv_quant=bool(cfg.quant_kv),
                prefill_chunk=cfg.prefill_chunk,
            ):
                n = int(gen_lens[0])
                if n > prev:
                    yield tokens[0, prev:n].tolist(), hiddens[0, prev:n]
                    prev = n
                if bool(done[0]):
                    return
            return
        for tokens, n, hiddens, done in stream_generate(
            self.model.llm, embeds, lens,
            max_new_tokens=max_new_tokens,
            stop_ids=(self.ids.eos,),
            cache_max_len=trim + max_new_tokens,
            chunk=chunk,
            vocab_size=cfg.llm.vocab_size,
            do_sample=do_sample,
            temperature=temperature,
            top_p=top_p,
            generator=self._generator(do_sample, seed),
            kv_quant=bool(cfg.quant_kv),
            prefill_chunk=cfg.prefill_chunk,
        ):
            k = int(n[0])
            if k:
                yield tokens[0, :k].tolist(), hiddens[0, :k]
            if bool(done[0]):
                return

    @torch.no_grad()
    def forward_hidden_states(self, input_ids: List[int], video_feats,
                              region_feats=None, region_token_counts=None):
        """One full forward of one sample. Returns (final-layer hidden
        states [1, S, hidden], splice plan)."""
        return self.forward_hidden_states_batch(
            [input_ids], video_feats, region_feats, [region_token_counts or []])

    @torch.no_grad()
    def forward_hidden_states_batch(self, input_ids_list: Sequence[List[int]], video_feats,
                                    region_feats=None, region_counts_list=None):
        """One full forward of B samples. Returns (final-layer hidden states
        [B, S, hidden], the shared splice plan)."""
        plan, embeds = self._splice_plan(
            input_ids_list, video_feats, region_feats, region_counts_list)
        hidden = forward_hidden(
            self.model.llm, embeds, torch.as_tensor(plan.seq_lens, device=self.device)
        )
        return hidden, plan

    # -------------------- SAM2 --------------------

    @torch.no_grad()
    def segment_video(
        self,
        images_sam,  # [T, S, S, 3] SAM-preprocessed floats, or raw uint8 [T, H, W, 3]
        seg_embeddings: torch.Tensor,  # [n_obj, sam_out_dim]
        out_height: int,
        out_width: int,
    ) -> np.ndarray:
        """``[SEG]`` embeddings → boolean masks [n_obj, T, H, W]: frames
        through Hiera + FPN, frame 0 conditioned on the embeddings, the rest
        propagated through the memory, low-res logits upsampled and
        thresholded at 0."""
        sam = self.model.sam
        feats = encode_video_frames(sam, self._sam_images(images_sam))
        low = propagate_video(sam, feats, seg_embeddings[:, None, :])
        masks = masks_to_video_res(low, out_height, out_width)
        return masks.permute(1, 0, 2, 3).cpu().numpy()

    @torch.no_grad()
    def segment_videos_batched(
        self,
        images_sam,  # [V, T, S, S, 3] SAM-preprocessed floats, or raw uint8 [V, T, H, W, 3]
        seg_embeddings: torch.Tensor,  # [V, sam_out_dim], one object per video
        out_height: int,
        out_width: int,
    ) -> np.ndarray:
        """V independent videos of T frames each, one ``[SEG]`` object a
        video → boolean masks [V, T, H, W]. All V · T frames are encoded in
        chunks; the propagation walks the T frames once with the videos
        riding the object-batch dimension."""
        images = _frames(images_sam)
        v, t = images.shape[:2]
        sam = self.model.sam
        feats = encode_video_frames(
            sam, self._sam_images(images.reshape((v * t,) + tuple(images.shape[2:]))))
        per_video = lambda a: a.reshape((v, t) + tuple(a.shape[1:]))
        vfeats = feats._replace(
            s0=per_video(feats.s0), s1=per_video(feats.s1), s2=per_video(feats.s2))
        low = propagate_videos_batched(sam, vfeats, seg_embeddings[:, None, :])
        masks = masks_to_video_res(low, out_height, out_width)  # [T, V, H, W]
        return masks.permute(1, 0, 2, 3).cpu().numpy()

    def _sam_images(self, images_sam) -> torch.Tensor:
        """Frames for SAM2 on the device: raw uint8 frames are resized and
        normalised there, floats are taken as preprocessed."""
        images = _on_device(images_sam, self.device)
        if images.dtype == torch.uint8:
            from .ops.image_pipeline import sam_preprocess_device

            images = sam_preprocess_device(images, out_dtype=self.cfg.compute_dtype)
        return images

    def _seg_masks(self, seg_hidden: torch.Tensor, images_sam, label_size) -> list:
        """Hidden states behind ``[SEG]`` tokens → one [T, H, W] mask stack
        per token."""
        embeds = self.model.seg_embeddings(seg_hidden)
        size = self.cfg.sam.hiera.image_size
        h, w = label_size if label_size is not None else (size, size)
        m = self.segment_video(images_sam, embeds, h, w)
        return [m[i] for i in range(m.shape[0])]


def _on_device(x, device) -> torch.Tensor:
    """Frames or masks as a tensor on ``device``: a tensor as it is (on
    whatever device it lies), anything else through a contiguous numpy
    array (torch refuses the negative strides of a reversed view)."""
    if not torch.is_tensor(x):
        x = np.ascontiguousarray(x)
    return torch.as_tensor(x, device=device)


def _frames(x):
    """A tensor as it is, anything else as a numpy array: ``.shape`` without
    copying frames off the card."""
    return x if torch.is_tensor(x) else np.asarray(x)


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "model_init: CUDA is not available on this machine; the port runs "
            "on the card by default. Pass device='cpu' to run on the CPU."
        )
    return device


def model_init(
    model_path: Optional[str] = None,
    *,
    cfg: Optional[UFVideoConfig] = None,
    device="cuda",
    seed: int = 0,
    tokenizer_path: Optional[str] = None,
    routing: Optional[VisionRouting] = None,
    sam_path: Optional[str] = None,
):
    """Build (runtime, processor, tokenizer). With ``model_path`` None the
    weights are random, drawn on ``device`` from ``seed`` with the JAX
    package's initialiser distributions, and the tokenizer is the offline
    byte tokenizer. With ``cfg.quant_llm`` / ``cfg.quant_vision`` each
    quantised layer draws the float layer's weights in the model's dtype,
    quantises them on ``device`` and frees the float copy, so the quantised
    model is the quantisation of the float model of the same seed.
    ``routing`` (``VisionRouting``, default the JAX package's default
    routing) picks the vision towers' kernels and modules; every routing
    holds the same parameters and draws the same weights from a seed.
    ``model_path``, ``tokenizer_path`` and ``sam_path`` (checkpoints) raise
    until checkpoint loading is ported."""
    device = _check_device(device)
    if model_path or tokenizer_path or sam_path:
        raise NotImplementedError(
            "checkpoint and HF tokenizer loading: ROADMAP.md queue 1 item 4 (checkpoints)"
        )
    cfg = cfg or UFVideoConfig()
    tokenizer, ids = byte_tokenizer_with_ids()
    cfg = cfg.replace(
        region_token_id=ids.region,
        seg_token_id=ids.seg,
        temporal_token_start_id=ids.temporal_start,
    )
    model = UFVideoModel.empty(cfg, device, routing)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model.reset_parameters(gen)
    return UFVideoRuntime(cfg, model, ids, device), None, tokenizer


def _assemble_input_ids(instruct, choice, modal_token, tokenizer):
    """Prompt assembly (choices 1 / 2 / 3) → multimodal-tokenized ids."""
    if choice in (1, 2):
        if isinstance(instruct, str):
            content = f"{modal_token}\n{instruct}" if choice == 1 else instruct
            message = [{"role": "user", "content": content}]
        else:
            # list-form instructs get the modal token under both choices
            message = [dict(m) for m in instruct]
            message[0]["content"] = f"{modal_token}\n" + message[0]["content"]
    elif choice == 3:
        roles = {"human": "user", "gpt": "assistant"}
        message = [
            {"role": roles.get(s["from"], s["from"]), "content": s["value"]}
            for s in instruct
        ]
    else:
        raise ValueError(f"unknown choice {choice}")
    prompt = tokenizer.apply_chat_template(message, tokenize=False, add_generation_prompt=True)
    return tokenizer_multimodal_token(prompt, tokenizer, modal_token)


def _video_pixels(model: UFVideoRuntime, image_or_video, modal: str) -> torch.Tensor:
    """One sample's frames on the device, ready for the tower: uint8 input
    is resized and normalized there, float32 is taken in the compute dtype;
    the image modal repeats its frame over the frame budget."""
    cfg = model.cfg
    pixels = _on_device(image_or_video, model.device)
    if pixels.dtype == torch.uint8:
        from .ops.image_pipeline import siglip_preprocess_device

        pixels = siglip_preprocess_device(pixels, out_dtype=cfg.compute_dtype)
    elif pixels.dtype == torch.float32 and cfg.compute_dtype == torch.bfloat16:
        pixels = pixels.to(torch.bfloat16)
    if modal == "image":
        pixels = pixels[:1].expand((cfg.budget.num_frames,) + tuple(pixels.shape[1:]))
    return pixels


def _encode_video_input(model: UFVideoRuntime, image_or_video, modal: str):
    """Vision encode for one sample (None for the text modal)."""
    if modal == "text":
        return None
    return model.encode_video(_video_pixels(model, image_or_video, modal)[None])


def _sampling(kwargs) -> dict:
    """The generation keywords of ``mm_infer`` and its siblings: greedy
    unless ``do_sample`` (then temperature 0.2 and top-p 0.9 unless given)."""
    do_sample = bool(kwargs.get("do_sample", False))
    temperature = kwargs.get("temperature")
    return dict(
        max_new_tokens=int(kwargs.get("max_new_tokens", 1024)),
        do_sample=do_sample,
        temperature=float(0.2 if temperature is None else temperature) if do_sample else 1.0,
        top_p=float(kwargs.get("top_p", 0.9)),
        seed=int(kwargs.get("seed", 0)),
    )


def _stop_sequences(tokenizer, stop_strings) -> tuple:
    return tuple(tuple(tokenizer(s, add_special_tokens=False).input_ids)
                 for s in stop_strings or [])


def _output_text(tokenizer, tokens, stop_strings) -> str:
    """Decoded text, cut at the first stop string (a string-level backstop:
    the tokenizer may merge a keyword with the text before it)."""
    text = tokenizer.decode(tokens, skip_special_tokens=True).strip()
    if stop_strings:
        text = trim_at_stop_strings(text, stop_strings).strip()
    return text


def mm_infer(
    image_or_video,
    instruct,
    model: UFVideoRuntime,
    tokenizer,
    modal: str = "video",
    masks=None,
    ann_indices=None,
    frame=None,
    choice: int = 1,
    images_sam=None,
    label_size=None,
    seg: bool = False,
    **kwargs,
):
    """Reference-compatible inference entry.

    image_or_video: [T, H, W, 3] frames (numpy, or a tensor on the CPU or
    the card, NHWC), uint8 raw or float preprocessed; ``frame``, ``masks``
    and ``images_sam`` may be tensors too. ``images_sam``: the frames SAM2 segments
    ([T, S, S, 3] preprocessed floats or raw uint8), ``label_size`` the
    (height, width) of the masks.

    Path A (no ``[SEG]`` in the input): generate, then segment one object per
    generated ``[SEG]`` from the hidden state of the step that produced it.
    Returns ``(text, {"output": ids, "pred_masks": [...]})``, or the dict
    alone when ``seg`` is set. Path B (``[SEG]`` in the input, choice 3): one
    forward, the hidden state at the position before each ``[SEG]``; returns
    ``{"output": None, "pred_masks": [...], "gt_masks": masks}``.

    Region referring: ``frame`` [F, H, W, 3] are the annotated frames,
    ``masks`` [F, Hm, Wm] one binary mask each, ``ann_indices`` the frames of
    each ``<region>`` placeholder of the prompt, in order (default: one
    region per frame). Each placeholder is replaced by its region's merged
    mask-pooled tokens."""
    modal_token = {
        "image": DEFAULT_IMAGE_TOKEN, "video": DEFAULT_VIDEO_TOKEN, "text": ""
    }[modal]
    input_ids = _assemble_input_ids(instruct, choice, modal_token, tokenizer)
    video_feats = _encode_video_input(model, image_or_video, modal)
    region_feats, region_counts = None, None
    if frame is not None and masks is not None:
        region_feats, region_counts = model.pack_and_encode_regions(frame, masks, ann_indices)

    if model.ids.seg in input_ids:
        # path B: hidden state at the position before each input [SEG]
        hidden, plan = model.forward_hidden_states(
            input_ids, video_feats, region_feats, region_counts)
        seg_positions = [
            int(plan.text_pos_map[0][ti]) - 1
            for ti, t in enumerate(input_ids) if t == model.ids.seg
        ]
        seg_positions = [p for p in seg_positions if p >= 0]
        pred_masks = []
        if seg_positions and images_sam is not None:
            pred_masks = model._seg_masks(hidden[0, seg_positions], images_sam, label_size)
        return {"output": None, "pred_masks": pred_masks, "gt_masks": masks}

    stop_strings = kwargs.get("stop_strings") or []
    tokens, hidden, _ = model.generate(
        input_ids, video_feats, region_feats, region_counts,
        stop_sequences=_stop_sequences(tokenizer, stop_strings), **_sampling(kwargs),
    )
    output_text = _output_text(tokenizer, tokens, stop_strings)
    out = {"output": tokens, "pred_masks": seg_masks_of_generation(
        model, tokens, hidden, images_sam, label_size)}
    if seg:
        return out
    return output_text, out


def seg_masks_of_generation(model: UFVideoRuntime, tokens, hidden: torch.Tensor,
                            images_sam, label_size) -> list:
    """Path A's post-hoc ``[SEG]`` extraction: one mask stack per generated
    ``[SEG]`` token, from the hidden state of the decode step that produced
    it (``hidden[i]`` is behind ``tokens[i]``)."""
    seg_steps = [i for i, t in enumerate(tokens) if t == model.ids.seg]
    if not seg_steps or images_sam is None:
        return []
    return model._seg_masks(hidden[seg_steps], images_sam, label_size)


def mm_infer_stream(
    image_or_video,
    instruct,
    model: UFVideoRuntime,
    tokenizer,
    modal: str = "video",
    masks=None,
    ann_indices=None,
    frame=None,
    choice: int = 1,
    chunk: int = 16,
    **kwargs,
):
    """Streaming QA: yields text deltas as decode chunks complete;
    ``"".join(deltas).strip()`` is ``mm_infer``'s text under the same
    sampling state. Path A only: a ``[SEG]`` in the input needs the full
    forward of ``mm_infer`` and raises ``ValueError``. ``stop_strings`` are
    honoured on the host between chunks (generation stops at most one chunk
    after the keyword; the text is cut exactly)."""
    modal_token = {
        "image": DEFAULT_IMAGE_TOKEN, "video": DEFAULT_VIDEO_TOKEN, "text": ""
    }[modal]
    input_ids = _assemble_input_ids(instruct, choice, modal_token, tokenizer)
    if model.ids.seg in input_ids:
        raise ValueError(
            "streaming covers QA generation only; a [SEG] in the input needs mm_infer")
    video_feats = _encode_video_input(model, image_or_video, modal)
    region_feats, region_counts = None, None
    if frame is not None and masks is not None:
        region_feats, region_counts = model.pack_and_encode_regions(frame, masks, ann_indices)
    # the streamer holds back a split multi-byte character and the last
    # characters a stop string could start in, so the joined deltas equal
    # the one-shot decode
    streamer = TextDeltaStreamer(tokenizer, kwargs.get("stop_strings") or [])
    for ids_chunk, _ in model.generate_stream(
        input_ids, video_feats, region_feats, region_counts, chunk=chunk, **_sampling(kwargs),
    ):
        delta, stopped = streamer.push(ids_chunk)
        if delta:
            yield delta
        if stopped:
            return
    delta = streamer.finish()
    if delta:
        yield delta


def mm_infer_batch(
    samples: Sequence[Dict[str, Any]],
    model: UFVideoRuntime,
    tokenizer,
    modal: str = "video",
    choice: int = 1,
    **kwargs,
):
    """Several independent requests in one encode, one generate (or one
    forward) and one SAM2 propagation, each with ``mm_infer``'s contract.

    Each sample is a dict: ``video`` ([T, H, W, 3] frames, the same T for
    all, uint8 or preprocessed floats), ``instruct``, and optionally
    ``masks`` / ``ann_indices`` / ``frame`` (region prompts), ``images_sam``
    (the same frame count across ``[SEG]`` samples) and ``label_size``.
    Samples without a ``[SEG]`` in the input take path A: one batched
    generate, then the hidden state behind each generated ``[SEG]``.
    Samples with one take path B: one forward over that subset, the hidden
    state at the position before each input ``[SEG]``. One-object samples
    of either path share one batched propagation when their frames and mask
    sizes agree; multi-object samples propagate on their own.

    Returns a list aligned with ``samples``: ``(text, {"output": ids,
    "pred_masks": [...]})`` for path A, ``(None, {"output": None,
    "pred_masks": [...], "gt_masks": masks})`` for path B."""
    cfg = model.cfg
    dev = model.device
    modal_token = {
        "image": DEFAULT_IMAGE_TOKEN, "video": DEFAULT_VIDEO_TOKEN, "text": ""
    }[modal]
    b = len(samples)
    ids_list = [_assemble_input_ids(s["instruct"], choice, modal_token, tokenizer)
                for s in samples]
    idx_a = [i for i, ids in enumerate(ids_list) if model.ids.seg not in ids]
    idx_b = [i for i in range(b) if i not in idx_a]

    video_feats = None
    if modal != "text":
        video_feats = model.encode_video(
            torch.stack([_video_pixels(model, s["video"], modal) for s in samples]))

    # each sample's region tokens, padded to one stream length
    region_feats, region_counts_list = None, None
    encoded = [model.pack_and_encode_regions(s["frame"], s["masks"], s.get("ann_indices"))
               if s.get("frame") is not None and s.get("masks") is not None else None
               for s in samples]
    if any(e is not None for e in encoded):
        first = next(e[0] for e in encoded if e is not None)
        rt_max = max(e[0].shape[1] for e in encoded if e is not None)
        region_feats = torch.zeros((b, rt_max, first.shape[-1]), dtype=first.dtype, device=dev)
        for i, e in enumerate(encoded):
            if e is not None:
                region_feats[i, :e[0].shape[1]] = e[0][0]
        region_counts_list = [e[1] if e is not None else [] for e in encoded]

    rows = lambda x, idx: None if x is None else x[torch.as_tensor(idx, device=dev)]
    counts = lambda idx: None if region_counts_list is None else [
        region_counts_list[i] for i in idx]
    size = cfg.sam.hiera.image_size
    label = lambda i: tuple(samples[i].get("label_size") or (size, size))
    images = lambda i: _frames(samples[i]["images_sam"])

    def segment(embeds_by_row: Dict[int, torch.Tensor]) -> Dict[int, list]:
        """[SEG] embeddings [n_obj, dim] by sample → mask stacks by sample:
        one-object samples in one batched propagation when their frames and
        mask sizes agree, the rest one sample at a time."""
        got: Dict[int, list] = {}
        single = [i for i, e in embeds_by_row.items() if e.shape[0] == 1]
        if single and len({label(i) for i in single}) == 1 \
                and len({tuple(images(i).shape) for i in single}) == 1:
            m = model.segment_videos_batched(
                torch.stack([_on_device(images(i), dev) for i in single]),
                torch.cat([embeds_by_row[i] for i in single]), *label(single[0]))
            got.update({i: [m[r]] for r, i in enumerate(single)})
        for i, e in embeds_by_row.items():
            if i not in got:
                m = model.segment_video(images(i), e, *label(i))
                got[i] = [m[j] for j in range(m.shape[0])]
        return got

    out: List[Any] = [None] * b
    stop_strings = kwargs.get("stop_strings") or []
    if idx_a:
        results, _ = model.generate_batch(
            [ids_list[i] for i in idx_a], rows(video_feats, idx_a),
            rows(region_feats, idx_a), counts(idx_a),
            stop_sequences=_stop_sequences(tokenizer, stop_strings), **_sampling(kwargs))
        embeds = {}
        for i, (tokens, hidden) in zip(idx_a, results):
            steps = [j for j, t in enumerate(tokens) if t == model.ids.seg]
            if steps and samples[i].get("images_sam") is not None:
                embeds[i] = model.model.seg_embeddings(hidden[steps])
        masks = segment(embeds)
        for i, (tokens, _) in zip(idx_a, results):
            out[i] = (_output_text(tokenizer, tokens, stop_strings),
                      {"output": tokens, "pred_masks": masks.get(i, [])})
    if idx_b:
        hidden, plan = model.forward_hidden_states_batch(
            [ids_list[i] for i in idx_b], rows(video_feats, idx_b),
            rows(region_feats, idx_b), counts(idx_b))
        embeds = {}
        for r, i in enumerate(idx_b):
            # the hidden state at the position before each input [SEG]
            positions = [int(plan.text_pos_map[r][ti]) - 1
                         for ti, t in enumerate(ids_list[i]) if t == model.ids.seg]
            positions = [p for p in positions if p >= 0]
            if positions and samples[i].get("images_sam") is not None:
                embeds[i] = model.model.seg_embeddings(hidden[r, positions])
        masks = segment(embeds)
        for i in idx_b:
            out[i] = (None, {"output": None, "pred_masks": masks.get(i, []),
                             "gt_masks": samples[i].get("masks")})
    return out
