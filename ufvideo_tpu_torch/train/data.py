"""Training dataset and static-budget collator (a copy of
``ufvideo_tpu/train/data.py`` on the port's host modules).

The reference's lazy supervised pipeline (conversation preprocessing, the
merged-JSON dataset, the collator) with every dynamic shape resolved on the
host into fixed budgets: spliced token layouts, per-region token counts,
SAM frame / object slots with validity masks.

Decoding (video, RLE) is host CPU work; the collator emits numpy only.
Frames are preprocessed at the tower's size (``cfg.vision.image_size``; the
JAX loaders take SigLIP's 384 whatever the config, the same at full width). PIL,
cv2 and imageio are reached only through the loaders that decode a file
(``mm_utils``, ``rle.poly_to_rle``); the collator resizes ground-truth masks
with its own nearest-neighbour rule, so samples built in memory need none of
them.
"""

from __future__ import annotations

import copy
import json
import os
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import rle
from ..configs import UFVideoConfig
from ..constants import (
    ANSWER_LIST,
    DEFAULT_VIDEO_TOKEN,
    IGNORE_INDEX,
    QUESTION_LIST,
)
from ..models.region_encoder import resize_mask_to_grid_np
from ..conversation import apply_chat_template
from ..mm_utils import process_video, sam_preprocess, tokenizer_multimodal_token
from ..splicing import SplicePlan, plan_splice


def preprocess_conversation(
    source: Sequence[Dict[str, str]],
    tokenizer,
    modal_token: Optional[str],
):
    """ChatML conversation → (input_ids, labels) with per-round masking:
    only assistant responses carry labels (reference: train.py:188-231)."""
    roles = {"human": "user", "gpt": "assistant"}
    if roles.get(source[0]["from"]) != "user":
        source = source[1:]
    message = [
        {"role": roles[s["from"]], "content": s["value"]} for s in source
    ]
    conversation = apply_chat_template(message, add_generation_prompt=False)
    input_ids = tokenizer_multimodal_token(conversation, tokenizer, modal_token)
    labels = list(input_ids)

    cur = 0
    history: List[Dict] = []
    for idx in range(1, len(source), 2):
        pair = [
            {"role": roles[source[idx - 1]["from"]], "content": source[idx - 1]["value"]},
            {"role": roles[source[idx]["from"]], "content": source[idx]["value"]},
        ]
        instruction = apply_chat_template(
            history + pair[:1], add_generation_prompt=True
        )
        full = apply_chat_template(history + pair, add_generation_prompt=False)
        ins_len = len(tokenizer_multimodal_token(instruction, tokenizer, modal_token))
        full_len = len(tokenizer_multimodal_token(full, tokenizer, modal_token))
        for i in range(cur, min(ins_len, len(labels))):
            labels[i] = IGNORE_INDEX
        cur = full_len
        history += pair
    return input_ids, labels


def normalize_modal_token(
    conversations: Sequence[Dict[str, str]], modal_token: str
) -> List[Dict[str, str]]:
    """Move the modal tag to the question head (reference: train.py:236-258
    preprocess_multimodal): strip it, prepend '<modal>\\n', strip again."""
    out = []
    for s in conversations:
        v = s["value"]
        if modal_token in v:
            v = v.replace(modal_token, "").strip()
            v = (modal_token + "\n" + v).strip()
        out.append({**s, "value": v})
    return out


def preprocess_plain(
    source: Sequence[Dict[str, str]],
    tokenizer,
    modal_token: str,
):
    """Projector-pretraining pairs (reference: train.py:159-185): the raw
    '<video> caption' concatenation, labels everywhere except the modal
    sentinel."""
    assert len(source) == 2 and modal_token in source[0]["value"]
    from ..constants import MODAL_INDEX_MAP

    conversation = " ".join(s["value"] for s in source)
    input_ids = tokenizer_multimodal_token(conversation, tokenizer, modal_token)
    sentinel = MODAL_INDEX_MAP[modal_token]
    labels = [IGNORE_INDEX if t == sentinel else t for t in input_ids]
    return input_ids, labels


@dataclass
class TrainSample:
    input_ids: List[int]
    labels: List[int]
    video: np.ndarray  # [T, H, W, 3]
    # region branch (optional)
    region_frames: Optional[np.ndarray] = None  # [F, H, W, 3]
    region_masks: Optional[np.ndarray] = None  # [F, Hm, Wm]
    ann_indices: Optional[List[List[int]]] = None
    # SAM branch (optional)
    images_sam: Optional[np.ndarray] = None  # [Ts, 1024, 1024, 3]
    gt_masks: Optional[np.ndarray] = None  # [n_obj, Ts, Hg, Wg]


class SupervisedVideoDataset:
    """Merged-JSON lazy dataset (reference: train.py:258-341).

    Task branches covered: plain video QA / referring (region annotations),
    templated classic segmentation (QUESTION_LIST/ANSWER_LIST,
    train.py:543-597), and image samples (expanded to the frame budget).
    Corrupt samples fall back to a random backup index (train.py:335-339).
    """

    def __init__(
        self,
        data_paths: Sequence[str],
        tokenizer,
        cfg: UFVideoConfig,
        video_root: str = "",
        seed: int = 0,
    ):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.video_root = video_root
        self.rng = random.Random(seed)
        self.records: List[Dict] = []
        for p in data_paths:
            data = json.load(open(p))
            for r in data:
                r["_source"] = os.path.basename(p)
            self.records.extend(data)

    def __len__(self):
        return len(self.records)

    def _dense_indices(self, total: int) -> List[int]:
        """Random SAM frame subset (train.py:311-315 get_dense_indices)."""
        n = self.cfg.budget.num_frames_sam
        if total <= n:
            return list(range(total)) + [max(total - 1, 0)] * (n - total)
        return sorted(self.rng.sample(range(total), n))

    def __getitem__(self, idx: int) -> TrainSample:
        for attempt in range(8):
            try:
                return self._load(self.records[idx])
            except Exception:
                # backup-sample retry (reference train.py:385-391) — but
                # LOUD, so pipeline bugs don't masquerade as corrupt data
                import traceback

                traceback.print_exc()
                print(f"sample {idx} failed; retrying with a random record")
                idx = self.rng.randrange(len(self.records))
        raise RuntimeError("too many corrupt samples")

    # -- reference seg-task layouts (train.py:418-597) --------------------

    def _ann_mask(self, seg_ann, h=None, w=None) -> np.ndarray:
        if seg_ann is None:
            return np.zeros((h, w), np.uint8)
        if isinstance(seg_ann, dict) and "segmentation" in seg_ann:
            seg_ann = seg_ann["segmentation"]
        return rle.ann_to_mask(seg_ann, h, w)

    def _load_unibench(self, rec: Dict) -> TrainSample:
        """UFVideo-Bench task1/2/3 branches (reference train.py:420-541).

        task1 (temporal region→mask): region prompt on a first frame chosen
        from the first quarter of frame_list, masks supervised on 4 random
        later frames. task2/task3: 4 random frames from frame_idx, zero
        region prompt masks, masks supervised on all 4.
        """
        cfg = self.cfg
        task = rec["unibench"]
        video_path = os.path.join(self.video_root, rec["video"])
        annotations = rec["annotation"]
        # the reference hardcodes 4 supervision frames (train.py:488,532 —
        # its num_frames_sam); here the configured budget generalizes it
        n_sam = cfg.budget.num_frames_sam

        if task == "task1":
            all_avail = sorted(rec["frame_list"])
            total = len(all_avail)
            quarter = max(1, total // 4)
            valid_first = [
                f for i, f in enumerate(all_avail[:quarter])
                if all_avail.index(f) + n_sam < total
            ]
            first = self.rng.choice(valid_first) if valid_first else all_avail[0]
            first_pos = all_avail.index(first)
            rand4 = sorted(self.rng.sample(all_avail[first_pos + 1:], n_sam))
            # ordered [first] + rand4 (the reference iterates a set here,
            # train.py:465-469 — we pin the natural deterministic order)
            frame_ids = [int(first)] + [int(f) for f in rand4]
            conversations = rec["conversations"]
        else:  # task2 / task3
            rand4 = sorted(self.rng.sample(list(rec["frame_idx"]), n_sam))
            frame_ids = [int(f) for f in rand4]
            first = None
            # task2/3 nest the conversation one level deeper (train.py:539)
            conversations = rec["conversations"][0] if (
                rec["conversations"] and isinstance(rec["conversations"][0], list)
            ) else rec["conversations"]

        video, dense, h, w, raw_dense = process_video(
            video_path,
            aspect_ratio="square",
            image_size=cfg.vision.image_size,
            num_frames=cfg.budget.num_frames,
            frame_idx=frame_ids,
        )

        conversations = normalize_modal_token(conversations, DEFAULT_VIDEO_TOKEN)
        input_ids, labels = preprocess_conversation(
            conversations, self.tokenizer, DEFAULT_VIDEO_TOKEN
        )
        sample = TrainSample(input_ids=input_ids, labels=labels, video=video)

        if task == "task1":
            # region prompt: first frame only (train.py:483 frame[0]), ONE
            # SLOT PER ANNOTATION all carrying the first frame's pixels —
            # the reference's masks list is parallel to the flattened
            # ann_indices=[[0]]*n (train.py:463,608-611), i.e. each
            # annotation pools frame-0 features against ITS OWN mask; SAM
            # supervision on the later frames (train.py:481 frames[1:])
            n_ann = len(annotations)
            sample.region_frames = np.repeat(dense[:1], max(n_ann, 1), 0)
            sample.region_masks = np.asarray(
                [self._ann_mask(ann[str(first)], h, w) for ann in annotations],
                np.float32,
            )
            sample.ann_indices = [[i] for i in range(n_ann)]
            sam_raw = raw_dense[1:]
        else:
            # zero region prompt (train.py:606-607): masks are zeros at the
            # reference's fixed 336 grid, SAM supervision on all 4 frames
            sample.region_frames = dense[:1]
            sample.region_masks = np.zeros((1, 336, 336), np.float32)
            sample.ann_indices = [[0]]
            sam_raw = raw_dense

        sample.images_sam = sam_preprocess(sam_raw, size=cfg.sam.hiera.image_size)
        gt = [
            np.stack([self._ann_mask(ann[str(j)], h, w) for j in rand4])
            for ann in annotations
        ]
        sample.gt_masks = np.stack(gt).astype(np.float32)
        return sample

    def _load_classic_seg(self, rec: Dict) -> TrainSample:
        """Classic per-frame-file segmentation (reference train.py:543-597):
        'video' is a list of frame image paths, conversations[0] is a class
        name formatted into a random QUESTION_LIST/ANSWER_LIST template."""
        cfg = self.cfg
        files = [os.path.join(self.video_root, f) for f in rec["video"]]
        sequence = rec["no_none_frame_idx"]
        n_sam = cfg.budget.num_frames_sam
        chosen = sorted(
            self.rng.sample(list(sequence), min(n_sam, len(sequence)))
        )
        while len(chosen) < n_sam:
            chosen.append(chosen[-1])

        video, dense, h, w, _ = process_video(
            files,
            aspect_ratio="square",
            image_size=cfg.vision.image_size,
            num_frames=cfg.budget.num_frames,
            frame_idx=sequence,
        )
        from ..mm_utils import load_frames

        sam_frames, _, _, _ = load_frames(
            [files[x] for x in chosen], num_frames=None
        )

        class_name = rec["conversations"][0]
        q = self.rng.choice(QUESTION_LIST).format(class_name=class_name)
        a = self.rng.choice(ANSWER_LIST)
        conversations = normalize_modal_token(
            [
                {"from": "human", "value": f"{DEFAULT_VIDEO_TOKEN}\n{q}"},
                {"from": "gpt", "value": a},
            ],
            DEFAULT_VIDEO_TOKEN,
        )
        input_ids, labels = preprocess_conversation(
            conversations, self.tokenizer, DEFAULT_VIDEO_TOKEN
        )
        sample = TrainSample(input_ids=input_ids, labels=labels, video=video)
        sample.region_frames = dense[:1]
        sample.region_masks = np.zeros((1, 336, 336), np.float32)
        sample.ann_indices = [[0]]
        sample.images_sam = sam_preprocess(
            sam_frames, size=cfg.sam.hiera.image_size
        )
        gt = np.stack(
            [self._ann_mask(rec["segmentations"][j], h, w) for j in chosen]
        )
        sample.gt_masks = gt[None].astype(np.float32)
        return sample

    def _load(self, rec: Dict) -> TrainSample:
        cfg = self.cfg
        # text-only records (language data — reference train.py:601-603
        # modal_token=None branch; the grouped sampler builds whole lang
        # megabatches of these): no vision input, zero pixels ride along
        # so the batch keeps static shapes
        if "video" not in rec and "image" not in rec:
            input_ids, labels = preprocess_conversation(
                rec["conversations"], self.tokenizer, DEFAULT_VIDEO_TOKEN
            )
            video = np.zeros(
                (
                    cfg.budget.num_frames,
                    cfg.vision.image_size,
                    cfg.vision.image_size,
                    3,
                ),
                np.float32,
            )
            return TrainSample(input_ids=input_ids, labels=labels, video=video)
        if "seg" in rec and "video" in rec:
            if rec.get("unibench") in ("task1", "task2", "task3"):
                return self._load_unibench(rec)
            if isinstance(rec["video"], list):
                return self._load_classic_seg(rec)
        # image samples are a single frame expanded to the frame budget
        # (reference: train.py:329-342, videorefer_arch.py:173-175)
        if "image" in rec and "video" not in rec:
            from ..mm_utils import process_image

            img, h, w, _ = process_image(
                os.path.join(self.video_root, rec["image"]),
                aspect_ratio="square",
            image_size=cfg.vision.image_size,
            )
            video = np.broadcast_to(
                img[:1], (cfg.budget.num_frames,) + img.shape[1:]
            ).copy()
            from ..constants import DEFAULT_IMAGE_TOKEN

            modal = (
                DEFAULT_IMAGE_TOKEN
                if any(
                    DEFAULT_IMAGE_TOKEN in s["value"]
                    for s in rec["conversations"]
                )
                else DEFAULT_VIDEO_TOKEN
            )
            input_ids, labels = preprocess_conversation(
                rec["conversations"], self.tokenizer, modal
            )
            return TrainSample(input_ids=input_ids, labels=labels, video=video)

        video_path = os.path.join(self.video_root, rec["video"])
        conversations = rec["conversations"]
        is_seg = "annotation" in rec and any(
            "[SEG]" in s["value"] for s in conversations if s["from"] == "gpt"
        )
        has_regions = "annotation" in rec and any(
            "<region>" in s["value"] for s in conversations
        )

        # classic-seg records may carry only a class name → template Q/A
        # (train.py:543-597)
        if rec.get("class_name") and not conversations:
            q = self.rng.choice(QUESTION_LIST).format(class_name=rec["class_name"])
            a = self.rng.choice(ANSWER_LIST)
            conversations = [
                {"from": "human", "value": f"{DEFAULT_VIDEO_TOKEN}\n{q}"},
                {"from": "gpt", "value": a},
            ]
            is_seg = True

        annotations = rec.get("annotation", [])
        # Region layout: ONE SLOT PER (annotation, frame) PAIR — the
        # reference's mask list runs parallel to the FLATTENED ann_indices
        # (train.py:366-375 builds indices into deduped frames, then
        # train.py:628-637 appends one mask per pair and layer.py:93-97
        # gathers feats[flatten(ann_indices)] against that parallel mask
        # list). Our static contract is one mask per frame slot, so pairs
        # become slots (frame pixels duplicated across same-frame slots —
        # decode stays deduped, the gather below fans out).
        layout_frames: List[int] = []  # original frame id per slot
        ann_indices: List[List[int]] = []
        if has_regions and annotations:
            for ann in annotations:
                idxs = []
                for f in ann.keys():
                    idxs.append(len(layout_frames))
                    layout_frames.append(int(f))
                ann_indices.append(idxs)

        # SAM supervision frames: sampled from the frames the annotations
        # actually key (the reference's seg variants likewise supervise on
        # annotated frames — train.py:563-586 no_none_frame_idx, 488-492
        # sampled frame_list keys); decoding rides the same process_video
        # call as the region frames.
        sam_keys: List[int] = []
        if is_seg and annotations:
            pools = [set(int(k) for k in a.keys()) for a in annotations]
            pool = sorted(set.intersection(*pools)) if pools else []
            if not pool and pools:
                pool = sorted(pools[0])
            if pool:
                n_sam = cfg.budget.num_frames_sam
                chosen = sorted(
                    self.rng.sample(pool, min(n_sam, len(pool)))
                )
                while len(chosen) < n_sam:
                    chosen.append(chosen[-1])
                sam_keys = chosen

        uniq = sorted(set(layout_frames) | set(sam_keys))
        video, dense, h, w, raw_dense = process_video(
            video_path,
            aspect_ratio="square",
            image_size=cfg.vision.image_size,
            num_frames=cfg.budget.num_frames,
            frame_idx=uniq or None,
        )
        pos = {f: i for i, f in enumerate(uniq)}

        input_ids, labels = preprocess_conversation(
            normalize_modal_token(conversations, DEFAULT_VIDEO_TOKEN),
            self.tokenizer, DEFAULT_VIDEO_TOKEN,
        )

        sample = TrainSample(
            input_ids=input_ids, labels=labels, video=video
        )

        def _mask_of(entry):
            seg_ann = (
                entry.get("segmentation") if isinstance(entry, dict) else entry
            )
            return (
                rle.ann_to_mask(seg_ann, h, w)
                if seg_ann is not None
                else np.zeros((h, w), np.uint8)
            )

        if has_regions and annotations:
            masks = []
            for ann in annotations:
                for f in ann.keys():
                    masks.append(_mask_of(ann[f]))
            sample.region_frames = dense[[pos[f] for f in layout_frames]]
            sample.region_masks = np.asarray(masks, np.float32)
            sample.ann_indices = ann_indices

        if sam_keys:
            sample.images_sam = sam_preprocess(
                [raw_dense[pos[k]] for k in sam_keys],
                size=cfg.sam.hiera.image_size,
            )
            gt = []
            for ann in annotations:
                amap = {int(kk): vv for kk, vv in ann.items()}
                frames = [
                    _mask_of(amap[k])
                    if k in amap
                    else np.zeros((h, w), np.uint8)
                    for k in sam_keys
                ]
                gt.append(np.stack(frames))
            if gt:
                sample.gt_masks = np.stack(gt).astype(np.float32)
        return sample


class Collator:
    """Static-budget batch assembly (reference collator: train.py:678-732,
    with the cross-batch ann_indices re-basing replaced by per-sample static
    region slots)."""

    def __init__(
        self,
        cfg: UFVideoConfig,
        region_token_id: int,
        seg_token_id: int,
        loss_mask_size: int = 512,
        native_loss_grids: int = 6,
        max_loss_side: int = 1024,
    ):
        self.cfg = cfg
        self.region_token_id = region_token_id
        self.seg_token_id = seg_token_id
        self.loss_mask_size = loss_mask_size
        # native-resolution mask loss (reference: videorefer_qwen2.py:299-305
        # computes bce/dice at each label's native H×W). Static shapes are
        # kept by registering up to ``native_loss_grids`` distinct (H, W)
        # loss grids as they appear in the data: a batch whose labels share
        # a registered resolution computes its loss EXACTLY at native
        # resolution (no resampling at all); only overflow resolutions fall
        # back to the nearest registered grid (nearest-neighbor GT resample,
        # the old fixed-512 deviation, now bounded by grid proximity).
        # ``native_loss_grids=0`` restores the fixed loss_mask_size grid.
        self.native_loss_grids = native_loss_grids
        self.max_loss_side = max_loss_side
        self._grids: List[Tuple[int, int]] = []

    def _loss_grid(self, samples) -> Tuple[int, int]:
        """Choose the (H, W) loss grid for this batch."""
        if not self.native_loss_grids:
            return self.loss_mask_size, self.loss_mask_size
        sizes = [
            tuple(s.gt_masks.shape[-2:])
            for s in samples
            if s.gt_masks is not None
        ]
        if not sizes:
            return self.loss_mask_size, self.loss_mask_size
        # majority native resolution of the batch, capped for memory
        want = max(set(sizes), key=sizes.count)
        scale = self.max_loss_side / max(want)
        if scale < 1.0:
            want = (
                max(int(round(want[0] * scale)), 1),
                max(int(round(want[1] * scale)), 1),
            )
        if want in self._grids:
            return want
        if len(self._grids) < self.native_loss_grids:
            self._grids.append(want)
            return want
        # closest registered grid by aspect-weighted area distance
        def dist(g):
            return abs(g[0] * g[1] - want[0] * want[1]) + abs(
                g[0] * want[1] - g[1] * want[0]
            )

        return min(self._grids, key=dist)

    def __call__(self, samples: Sequence[TrainSample]) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = len(samples)
        budget = cfg.budget
        v = cfg.num_video_tokens
        rt = cfg.region.region_token_num

        # truncate to the region budget — region_segments/encode_regions
        # only cover max_regions, so overflow placeholders must not get
        # splice slots pointing past the feature array
        region_counts = [
            [
                min(len(ix), rt)
                for ix in (s.ann_indices or [])[: budget.max_regions]
            ]
            for s in samples
        ]
        plan = plan_splice(
            [s.input_ids for s in samples],
            num_video_tokens=v,
            region_token_counts=region_counts,
            region_token_id=self.region_token_id,
            max_seq_len=budget.max_seq_len,
            labels=[s.labels for s in samples],
            region_stride=rt,
        )

        pixels = np.stack([s.video for s in samples])
        out: Dict[str, Any] = {
            "pixels": pixels.astype(np.float32),
            "text_ids": plan.text_ids,
            "src_kind": plan.src_kind,
            "src_idx": plan.src_idx,
            "seq_lens": plan.seq_lens,
            "labels": plan.labels,
        }

        # region branch padded to budgets
        f_budget = max(
            (len(s.region_frames) for s in samples if s.region_frames is not None),
            default=0,
        )
        if f_budget:
            r_budget = budget.max_regions
            hw = next(
                s.region_frames.shape[1]
                for s in samples
                if s.region_frames is not None
            )
            # masks go to the vision patch grid HOST-side, each at its own
            # native resolution (zero-padding to a batch-max canvas before
            # resizing would shrink smaller samples' masks into a corner of
            # the grid while their frames were resized full-frame); also
            # keeps the train step's input shapes independent of per-video
            # mask resolutions
            grid = cfg.vision.image_size // cfg.vision.patch_size
            rf = np.zeros((b, f_budget, hw, hw, 3), np.float32)
            rm = np.zeros((b, f_budget, grid, grid), np.float32)
            fv = np.zeros((b, f_budget), bool)
            seg = np.zeros((b, r_budget, f_budget), bool)
            for bi, s in enumerate(samples):
                if s.region_frames is None:
                    continue
                n = len(s.region_frames)
                rf[bi, :n] = s.region_frames
                k = min(len(s.region_masks), f_budget)
                rm[bi, :k] = resize_mask_to_grid_np(
                    s.region_masks[:k], grid
                )
                fv[bi, :n] = True
                for ri, idxs in enumerate(s.ann_indices[: r_budget]):
                    for i in idxs:
                        if i < f_budget:
                            seg[bi, ri, i] = True
            out.update(
                region_frames=rf, region_masks=rm,
                region_frame_valid=fv, region_segments=seg,
            )

        # SAM branch padded to (max_objects, num_frames_sam). The mask loss
        # grid is chosen per batch from the registered native-resolution
        # buckets (see _loss_grid): a batch at a registered resolution
        # computes its loss exactly at native resolution, matching the
        # reference (videorefer_qwen2.py:299-305); only overflow resolutions
        # are nearest-resampled to the closest registered grid, so a run
        # meets at most ``native_loss_grids`` loss shapes.
        if any(s.images_sam is not None for s in samples):
            ts = budget.num_frames_sam
            ss = cfg.sam.hiera.image_size
            n_obj = budget.max_objects
            gh, gw = self._loss_grid(samples)
            ims = np.zeros((b, ts, ss, ss, 3), np.float32)
            gts = np.zeros((b, n_obj, ts, gh, gw), np.float32)
            obj_valid = np.zeros((b, n_obj), bool)
            for bi, s in enumerate(samples):
                if s.images_sam is None:
                    continue
                k = min(len(s.images_sam), ts)
                ims[bi, :k] = s.images_sam[:k]
                if s.gt_masks is not None:
                    k = min(s.gt_masks.shape[0], n_obj)
                    for oi in range(k):
                        for ti in range(min(ts, s.gt_masks.shape[1])):
                            m = s.gt_masks[oi, ti]
                            gts[bi, oi, ti] = resize_nearest(m, gh, gw)
                    obj_valid[bi, :k] = True
            out.update(images_sam=ims, gt_masks=gts, obj_valid=obj_valid)
        return out


def resize_nearest(m: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST)``: output
    pixel i takes source floor(i · src / dst), clamped."""
    if m.shape == (h, w):
        return m
    rows = np.minimum(np.floor(np.arange(h) * (m.shape[0] / h)).astype(np.int64), m.shape[0] - 1)
    cols = np.minimum(np.floor(np.arange(w) * (m.shape[1] / w)).astype(np.int64), m.shape[1] - 1)
    return m[rows[:, None], cols[None, :]]


def modality_length_groups(
    lengths: Sequence[int], modalities: Sequence[bool], batch_size: int, seed: int = 0
) -> List[int]:
    """Length/modality-grouped sample order (reference:
    videorefer_trainer.py:171-197 get_modality_length_grouped_indices):
    shuffle each modality, sort by length inside megabatches of one global
    batch, then SHUFFLE THE MM AND LANG MEGABATCHES TOGETHER so text-only
    data stays interleaved through the epoch (the two groups' last partial
    megabatches combine into one trailing batch, as in the reference)."""
    rng = np.random.RandomState(seed)
    mm = [i for i, m in enumerate(modalities) if m]
    lang = [i for i, m in enumerate(modalities) if not m]

    def megabatches(indices: List[int]) -> List[List[int]]:
        idx = list(rng.permutation(indices))
        return [
            sorted(idx[i : i + batch_size], key=lambda j: -lengths[j])
            for i in range(0, len(idx), batch_size)
        ]

    if not mm or not lang:
        return [i for m in megabatches(mm or lang) for i in m]
    mm_megas, lang_megas = megabatches(mm), megabatches(lang)
    extra = mm_megas.pop() + lang_megas.pop()
    megas = mm_megas + lang_megas
    order = [megas[i] for i in rng.permutation(len(megas))]
    out = [i for m in order for i in m]
    out.extend(sorted(extra))
    return out
