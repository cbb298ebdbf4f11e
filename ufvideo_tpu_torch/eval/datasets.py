"""Benchmark dataset adapters: a copy of ``ufvideo_tpu/eval/datasets.py``.

Each adapter turns a benchmark's annotation JSON into sample dicts (numpy
NHWC pixel arrays and region metadata) for the shared runner (``run.py``),
with the per-benchmark frame protocols of the reference scripts, the dense
frames of the SAM branch and the span-formatted temporal targets. Frames
are decoded and preprocessed on the host by ``mm_utils`` (a directory of
``.png`` frames needs neither cv2 nor PIL).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import rle
from ..constants import NUM_FRAMES
from ..mm_utils import load_frames, process_video, sam_preprocess


def _annotation_layout(annotations: List[Dict]) -> Dict[str, Any]:
    """Annotation bookkeeping translated to this framework's region-slot
    contract: ONE SLOT PER (annotation, frame) PAIR. The reference decodes
    the deduped frame union and gathers feats[flatten(ann_indices)] against
    a pair-parallel mask list (inference_videorefer_d_bench.py:101-132,
    layer.py:93-97); pair slots (frame pixels duplicated across same-frame
    slots) reproduce that pairing exactly."""
    pair_frames: List[int] = []  # original frame id per slot
    ann_indices: List[List[int]] = []
    for ann in annotations:
        idxs = []
        for f in ann.keys():
            idxs.append(len(pair_frames))
            pair_frames.append(int(f))
        ann_indices.append(idxs)
    return {
        "frame_ids": sorted(set(pair_frames)),  # decode each frame once
        "pair_frames": pair_frames,
        "ann_indices": ann_indices,
    }


def _decode_masks(
    annotations: List[Dict], height: int, width: int
) -> np.ndarray:
    """Per (region, frame) masks in annotation order
    (inference_PixRQA.py:127-137)."""
    masks = []
    for ann in annotations:
        for f in ann.keys():
            seg = ann[f].get("segmentation") if isinstance(ann[f], dict) else ann[f]
            if seg is None:
                masks.append(np.zeros((height, width), np.uint8))
            else:
                masks.append(rle.ann_to_mask(seg, height, width))
    return np.asarray(masks)


class SegReferBenchmark:
    """PixRQA / PixHQA / PixTRQA / VideoRefer-D/Q style samples: video +
    region annotations (+ SAM frames for [SEG] decoding), with the
    per-benchmark frame protocols of the reference scripts:

    - pixrqa (inference_PixRQA.py:102-150): region = FIRST annotated frame
      with the first annotation's first mask (the reference overrides
      ann_indices to [[[0]]] and the region encoder then reads only
      masks[0]); SAM frames = the sorted annotated frames MINUS the first.
    - videorefer_d / videorefer_q (inference_videorefer_d_bench.py:94-134):
      all (annotation, frame) pair regions; SAM frames = all annotated
      frames; ``--mode single`` keeps only the nominated frame per region.
    - pixhqa / pixtrqa (inference_PixHQA.py:105-120): NO regions; frames
      decoded at line['frame_idx'] feed the SAM branch directly.
    - generic (mevis-style / other): pair regions + uniformly sampled SAM
      frames.
    """

    def __init__(
        self,
        video_folder: str,
        data_list: Sequence[Dict],
        num_frames: int = NUM_FRAMES,
        num_sam_frames: Optional[int] = None,
        aspect_ratio: str = "square",
        mode: Optional[str] = None,
        image_size: Optional[int] = None,
        sam_image_size: Optional[int] = None,
        benchmark: str = "generic",
    ):
        self.video_folder = video_folder
        self.data_list = list(data_list)
        self.num_frames = num_frames
        self.num_sam_frames = num_sam_frames
        self.aspect_ratio = aspect_ratio
        self.mode = mode
        self.image_size = image_size
        self.sam_image_size = sam_image_size
        self.benchmark = benchmark

    def __len__(self):
        return len(self.data_list)

    def _sam(self, frames) -> np.ndarray:
        return (
            sam_preprocess(frames, self.sam_image_size)
            if self.sam_image_size
            else sam_preprocess(frames)
        )

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        line = self.data_list[idx]
        bench = self.benchmark
        video_path = os.path.join(self.video_folder, line["video"])
        annotations = line.get("annotation", [])
        if self.mode == "single" and "frame_idx" in line:
            # single-frame mode: keep only the sample's nominated frame per
            # region (inference_videorefer_d_bench.py:94-99; the q-bench
            # script shares the flag)
            fidx = str(line["frame_idx"])
            annotations = [{fidx: ann[fidx]} for ann in annotations]

        use_regions = bool(annotations) and bench not in ("pixhqa", "pixtrqa")
        layout = _annotation_layout(annotations) if use_regions else None
        if bench in ("pixhqa", "pixtrqa"):
            fi = line["frame_idx"]
            if not isinstance(fi, (list, tuple)):
                fi = [fi]
            frame_idx = [int(f) for f in fi]
        else:
            frame_idx = layout["frame_ids"] if layout else None

        kw = {"image_size": self.image_size} if self.image_size else {}
        video, dense, h, w, raw_dense = process_video(
            video_path,
            aspect_ratio=self.aspect_ratio,
            num_frames=self.num_frames,
            frame_idx=frame_idx,
            **kw,
        )
        caption = line.get("caption")
        if caption is None and bench in ("pixhqa", "pixtrqa"):
            # gt caption rides in the conversation (inference_PixHQA.py:93)
            caption = line["conversations"][0][1]["value"]
        sample: Dict[str, Any] = {
            "id": line.get("id", idx),
            "video_name": line["video"],
            "video": video,
            "height": h,
            "width": w,
            "caption": caption,
            "line": line,
        }

        if layout:
            pos = {f: i for i, f in enumerate(layout["frame_ids"])}
            masks = _decode_masks(annotations, h, w)
            if bench == "pixrqa":
                # ONE region: first (sorted) annotated frame + masks[0]
                # (the reference's ann_indices=[[[0]]] override makes the
                # region encoder read exactly feats[0] against masks[0])
                sample["frame"] = dense[:1]
                sample["masks"] = masks[:1]
                sample["ann_indices"] = [[0]]
            else:
                sample["frame"] = dense[
                    [pos[f] for f in layout["pair_frames"]]
                ]
                sample["masks"] = masks
                sample["ann_indices"] = layout["ann_indices"]

        # SAM branch (direct-resize to 1024² + SAM normalization)
        if bench == "pixrqa" and layout:
            sam_raw = raw_dense[1:] if len(raw_dense) > 1 else raw_dense
        elif bench in ("videorefer_d", "videorefer_q") and layout:
            sam_raw = raw_dense
        elif bench in ("pixhqa", "pixtrqa"):
            sam_raw = raw_dense
        else:
            sam_raw, _, _, _ = load_frames(
                video_path, num_frames=self.num_sam_frames or self.num_frames
            )
        sample["images_sam"] = self._sam(sam_raw)
        return sample


class MCQABenchmark:
    """MVBench-style MCQA samples."""

    def __init__(self, video_folder: str, data_list, num_frames: int = NUM_FRAMES,
                 image_size: Optional[int] = None):
        self.video_folder = video_folder
        self.data_list = list(data_list)
        self.num_frames = num_frames
        self.image_size = image_size

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        line = self.data_list[idx]
        d = line["data"] if "data" in line else line
        video_path = os.path.join(self.video_folder, d.get("video", ""))
        bound = None
        if line.get("bound"):
            bound = (d.get("start"), d.get("end"))
        video, _, h, w, _ = process_video(
            video_path,
            s=bound[0] if bound else None,
            e=bound[1] if bound else None,
            # mvbench runs with aspect_ratio=None — plain resize, no square
            # padding (inference_video_mcqa_mvbench.py:224)
            aspect_ratio="square",
            num_frames=self.num_frames,
            **({"image_size": self.image_size} if self.image_size else {}),
        )
        question = d["question"]
        options = d["candidates"]
        letters = [chr(ord("A") + i) for i in range(len(options))]
        # byte-match the reference instruct (inference_video_mcqa_mvbench.py
        # :90-97): 'Question: ' prefix, '(X) option\n' per line
        options_string = "".join(
            f"({l}) {o}\n" for l, o in zip(letters, options)
        )
        prompt = (
            f"Question: {question}\nOptions:\n{options_string}"
            "Answer with the option's letter from the given choices "
            "directly and only give the best option."
        )
        gt_letter = letters[options.index(d["answer"])]
        return {
            "id": line.get("id", idx),
            "video": video,
            "question": prompt,
            "options": options,
            "gt": gt_letter,
            "task_type": line.get("task_type", ""),
        }


class TVGBenchmark:
    """Charades-STA temporal grounding samples."""

    PROMPT = (
        "When is <event> occur in the video? Only give the start and end "
        "timestamp."
    )

    def __init__(self, video_folder: str, data_list, num_frames: int = NUM_FRAMES,
                 image_size: Optional[int] = None):
        self.video_folder = video_folder
        self.data_list = list(data_list)
        self.num_frames = num_frames
        self.image_size = image_size

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        line = self.data_list[idx]
        # reference Charades-STA schema: image_id / caption / timestamp
        # (inference_video_TVG.py:251-261); converted files may use
        # video / query / timestamps instead
        vid = line.get("video") or line["image_id"]
        video_path = os.path.join(self.video_folder, vid)
        video, _, h, w, _ = process_video(
            video_path, num_frames=self.num_frames,
            # reference runs TVG with aspect_ratio='square' (plain resize,
            # inference_video_TVG.py:379)
            aspect_ratio="square",
            **({"image_size": self.image_size} if self.image_size else {}),
        )
        query = line.get("query") or line.get("event") or line.get("caption")
        # reference normalization: strip dots, strip spaces, LOWERCASE
        # (inference_video_TVG.py:252-253)
        query = query.strip(".").strip(" ").lower()
        return {
            "id": line.get("id", idx),
            "vid": vid,
            "video": video,
            "question": self.PROMPT.replace("<event>", query),
            "gt": (
                line.get("timestamps")
                or line.get("timestamp")
                or line.get("gt")
            ),
        }
