"""Checkpoint IO: the reference's torch artifacts into the port's modules
(mirrors ``ufvideo_tpu/checkpoints.py``).

Reads the reference's three artifact flavours:

  1. full model checkpoints: a file, or an HF directory of ``*.safetensors``
     or ``pytorch_model*.bin`` shards;
  2. adapter-only ``mm_projector.bin`` / ``region_encoder.bin``;
  3. the standalone SAM2 ``sam2_hiera_large.pt`` (``model.`` prefix,
     ``.gamma`` names),

merges PEFT LoRA adapters into a state dict, and writes a state dict into a
``UFVideoModel`` (``convert_full_checkpoint``).

Nothing here holds a float copy of the model on the host: ``.safetensors``
files are read by the reader below as views of one ``mmap`` of each file (the
``safetensors`` package is not needed), ``.bin`` files through
``torch.load(mmap=True)``, and each tensor is copied to its parameter, on the
parameter's device and in its dtype, when the converter reaches it. Nothing
writes into those views.

``save_params`` / ``load_params`` / ``latest_checkpoint`` keep a training
run's state (the JAX module's orbax functions; orbax's format cannot be read
without JAX): a ``checkpoint-{step}`` directory with ``tensors.pt`` (every
tensor of a nested dict, by its ``/``-joined path, on the host) and
``meta.json`` (the other leaves: the step, the optimizer's count).
"""

from __future__ import annotations

import json
import math
import mmap
import os
import warnings
from typing import Any, Dict, Mapping, Optional

import torch

from .configs import UFVideoConfig, VisionRouting
from .models.sam2.convert import convert_sam2
from .models.ufvideo import UFVideoModel
from .weights import (
    TensorWriter,
    convert_projector,
    convert_qwen2,
    convert_region_encoder,
    convert_siglip,
    convert_text_hidden_fcs,
)

# safetensors dtype names → (the dtype, the dtype ``torch.frombuffer`` reads
# the bytes as before ``.view``)
_SAFETENSORS_DTYPES = {
    "BF16": (torch.bfloat16, torch.int16), "F16": (torch.float16, torch.float16),
    "F32": (torch.float32, torch.float32), "F64": (torch.float64, torch.float64),
    "I64": (torch.int64, torch.int64), "I32": (torch.int32, torch.int32),
    "I16": (torch.int16, torch.int16), "I8": (torch.int8, torch.int8),
    "U8": (torch.uint8, torch.uint8), "BOOL": (torch.bool, torch.uint8),
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file → {key: CPU tensor}, each a read-only view of
    one ``mmap`` of the file. The format: an 8-byte little-endian header
    length, a JSON header {key: {"dtype", "shape", "data_offsets": [begin,
    end]}} (offsets into the data after the header; ``__metadata__`` is not
    a tensor), then the data. A header that does not parse, an unknown
    dtype, and offsets that overlap, run past the file or do not match the
    shape raise ``ValueError`` naming the file (and the key)."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        head = f.read(8)
        n = int.from_bytes(head, "little") if len(head) == 8 else -1
        if n < 0 or n > size - 8:
            raise ValueError(f"{path}: not a safetensors file (header length {n}, "
                             f"file of {size} bytes)")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: the safetensors header does not parse: {e}") from None
        if not isinstance(header, dict):
            raise ValueError(f"{path}: the safetensors header is not a JSON object")
        data_size = size - 8 - n
        spans = []
        for key, entry in header.items():
            if key == "__metadata__":
                continue
            try:
                dtype, raw = _SAFETENSORS_DTYPES[entry["dtype"]]
                shape = [int(d) for d in entry["shape"]]
                begin, end = (int(o) for o in entry["data_offsets"])
            except KeyError as e:
                raise ValueError(f"{path}: tensor {key!r}: unknown dtype or missing field "
                                 f"{e}") from None
            except (TypeError, ValueError) as e:
                raise ValueError(f"{path}: tensor {key!r}: malformed entry: {e}") from None
            numel = math.prod(shape)
            if not 0 <= begin <= end <= data_size or end - begin != numel * raw.itemsize:
                raise ValueError(
                    f"{path}: tensor {key!r}: offsets [{begin}, {end}) do not hold "
                    f"{shape} {entry['dtype']} inside {data_size} bytes of data")
            spans.append((begin, end, key, dtype, raw, shape))
        spans.sort(key=lambda s: s[:2])
        for a, b in zip(spans, spans[1:]):
            if b[0] < a[1]:
                raise ValueError(f"{path}: tensors {a[2]!r} and {b[2]!r} overlap")
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) if data_size else None
    out: Dict[str, torch.Tensor] = {}
    with warnings.catch_warnings():
        # the views are read-only: nothing here or in the converters writes them
        warnings.filterwarnings("ignore", message="The given buffer is not writable")
        for begin, end, key, dtype, raw, shape in spans:
            if begin == end:
                out[key] = torch.empty(shape, dtype=dtype)
                continue
            t = torch.frombuffer(buf, dtype=raw, count=(end - begin) // raw.itemsize,
                                 offset=8 + n + begin)
            out[key] = t.view(dtype).reshape(shape)
    return out


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def _load_file(path: str) -> Dict[str, Any]:
    """One ``.safetensors`` or torch file, as it is."""
    return read_safetensors(path) if path.endswith(".safetensors") else _torch_load(path)


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """A state dict from a file or an HF checkpoint directory (all its
    ``*.safetensors`` shards, else its ``pytorch_model*.bin`` shards), as
    CPU tensors backed by the files. A single file's ``"model"`` entry is
    taken when it has one (shards are taken as they are, as in the JAX
    package)."""
    if os.path.isfile(path):
        sd = _load_file(path)
        return sd.get("model", sd) if isinstance(sd, dict) else sd
    files = sorted(os.listdir(path))
    out: Dict[str, Any] = {}
    shards = [f for f in files if f.endswith(".safetensors")]
    if shards:
        for f in shards:
            out.update(read_safetensors(os.path.join(path, f)))
        return out
    for f in files:
        if f.startswith("pytorch_model") and f.endswith(".bin"):
            out.update(_torch_load(os.path.join(path, f)))
    if not out:
        raise FileNotFoundError(f"no checkpoint shards found in {path}")
    return out


def load_sam2_checkpoint(path: str) -> Dict[str, Any]:
    """``sam2_hiera_large.pt`` with the reference's key fixups: its
    ``"model"`` entry, the ``model.`` prefix stripped, ``.gamma`` →
    ``.g_weight``."""
    sd = _torch_load(path)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    return {k.removeprefix("model.").replace(".gamma", ".g_weight"): v for k, v in sd.items()}


def load_adapter_weights(path: str) -> Dict[str, Any]:
    """``mm_projector.bin`` / ``region_encoder.bin`` with the module prefix
    stripped, so that the converters take it as it is."""
    out = {}
    for k, v in _torch_load(path).items():
        for prefix in ("model.mm_projector.", "mm_projector.",
                       "model.region_encoder.", "region_encoder."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        out[k] = v
    return out


def _strip(sd: Mapping, prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def infer_vocab_size(sd: Mapping) -> int:
    return int(sd["model.embed_tokens.weight"].shape[0])


_SAM_PREFIX = "model.mask_encoder.sam2_model."


def convert_full_checkpoint(
    sd: Mapping,
    cfg: UFVideoConfig,
    sam_sd: Optional[Mapping] = None,
    model: Optional[UFVideoModel] = None,
    *,
    device="cuda",
    routing: Optional[VisionRouting] = None,
) -> UFVideoModel:
    """A full reference state dict → ``model`` (by default
    ``UFVideoModel.empty(cfg, device, routing)``, on the card unless
    ``device`` says otherwise), written in place and returned. The LLM is at
    the top level, the tower under ``model.vision_tower.vision_tower.``, the projector under
    ``model.mm_projector.``, the region encoder and ``text_hidden_fcs`` under
    their ``model.`` paths. SAM2 comes from ``sam_sd`` (a standalone SAM2
    state dict, ``load_sam2_checkpoint``), else from the checkpoint's
    ``model.mask_encoder.sam2_model.`` keys; with neither, the model keeps no
    SAM2 (``model.sam`` is None, and a ``[SEG]`` request raises). Quantised
    configurations quantise each layer as it is written. Keys the model does
    not use are ignored; a parameter the checkpoint does not write raises."""
    if model is None:
        model = UFVideoModel.empty(cfg, device, routing)
    if sam_sd is None and any(k.startswith(_SAM_PREFIX) for k in sd):
        sam_sd = _strip(sd, _SAM_PREFIX)
    if sam_sd is None:
        model.sam = None
    w = TensorWriter()
    convert_qwen2(w, model.llm, sd)
    convert_siglip(w, model.vision, _strip(sd, "model.vision_tower.vision_tower."))
    convert_projector(w, model.projector, _strip(sd, "model.mm_projector."))
    convert_region_encoder(w, model.region, _strip(sd, "model.region_encoder."))
    convert_text_hidden_fcs(w, model.text_fcs, _strip(sd, "model."))
    if sam_sd is not None:
        convert_sam2(w, model.sam, sam_sd)
    w.check_all_written(model)
    return model


def convert_base_plus_adapters(
    base_sd: Mapping,
    cfg: UFVideoConfig,
    projector_path: Optional[str] = None,
    region_path: Optional[str] = None,
    sam_sd: Optional[Mapping] = None,
    model: Optional[UFVideoModel] = None,
    *,
    device="cuda",
    routing: Optional[VisionRouting] = None,
) -> UFVideoModel:
    """The reference's pretrain loading path: a base checkpoint plus the
    separately saved adapters, whose tensors take the place of the base's
    projector / region encoder. (The JAX function converts the base's
    projector and region encoder first and so needs them in the base; here
    the adapters are laid over the state dict, so a base without them loads
    too.)"""
    sd = dict(base_sd)
    for path, prefix in ((projector_path, "model.mm_projector."),
                         (region_path, "model.region_encoder.")):
        if path:
            sd = {k: v for k, v in sd.items() if not k.startswith(prefix)}
            sd.update({prefix + k: v for k, v in load_adapter_weights(path).items()})
    return convert_full_checkpoint(sd, cfg, sam_sd, model, device=device, routing=routing)


def merge_lora(
    sd: Dict[str, Any],
    adapter_sd: Mapping,
    *,
    alpha: float,
    r: Optional[int] = None,
) -> Dict[str, Any]:
    """Merge PEFT LoRA adapters into the base state dict in place: for each
    ``base_model.model.<path>.lora_A.weight`` / ``.lora_B.weight`` pair, W ←
    W + (alpha / r) · B @ A in float32, cast back to W's dtype (r defaults to
    A's rank). ``alpha`` is required: PEFT keeps it in
    ``adapter_config.json`` (``merge_lora_from_dir``), and the reference
    trains alpha 16, r 8. The adapter's other tensors (the non-LoRA
    trainables) take the place of the base's."""
    lora_a = {
        k.replace(".lora_A.weight", ""): v
        for k, v in adapter_sd.items()
        if k.endswith(".lora_A.weight")
    }
    for base_key, a in lora_a.items():
        b = adapter_sd[base_key + ".lora_B.weight"]
        target = base_key.removeprefix("base_model.model.") + ".weight"
        if target not in sd:
            continue
        scale = alpha / (r or a.shape[0])
        w = sd[target]
        sd[target] = (w.float() + scale * (b.float() @ a.float())).to(w.dtype)
    for k, v in adapter_sd.items():
        if ".lora_" not in k:
            sd[k.removeprefix("base_model.model.")] = v
    return sd


def merge_lora_from_dir(sd: Dict[str, Any], adapter_dir: str) -> Dict[str, Any]:
    """Merge a PEFT adapter directory: ``lora_alpha`` and ``r`` from its
    ``adapter_config.json``, the adapters from ``adapter_model.safetensors``
    or ``.bin``, and ``non_lora_trainables.bin`` / ``.safetensors`` when
    present."""
    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        acfg = json.load(f)
    adapter_sd = dict(_load_file(_first_existing(
        adapter_dir, ("adapter_model.safetensors", "adapter_model.bin"))))
    non_lora = _first_existing(
        adapter_dir, ("non_lora_trainables.bin", "non_lora_trainables.safetensors"),
        required=False)
    if non_lora:
        adapter_sd.update(_load_file(non_lora))
    return merge_lora(sd, adapter_sd, alpha=float(acfg["lora_alpha"]), r=int(acfg["r"]))


def _first_existing(d: str, names, required: bool = True) -> Optional[str]:
    for n in names:
        p = os.path.join(d, n)
        if os.path.exists(p):
            return p
    if required:
        raise FileNotFoundError(f"none of {names} in {d}")
    return None


# --------------------------------------------------------------------------
# training state checkpoints
# --------------------------------------------------------------------------

def _flat(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def save_params(path: str, tree: Mapping) -> None:
    """Write a nested dict of tensors and plain values (ints, floats,
    strings, None) to the directory ``path``; tensors are copied to the
    host as written, in their dtype."""
    os.makedirs(path, exist_ok=True)
    flat = _flat(tree)
    tensors = {k: v.detach().cpu() for k, v in flat.items() if torch.is_tensor(v)}
    meta = {k: v for k, v in flat.items() if not torch.is_tensor(v)}
    torch.save(tensors, os.path.join(path, "tensors.pt"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_params(path: str, template: Optional[Mapping] = None) -> Dict[str, Any]:
    """Read a ``save_params`` directory. With ``template`` (a nested dict of
    the same paths) each tensor is copied into the template's tensor in
    place, on its device and in its dtype, and a path the directory lacks
    raises; the returned dict holds the template's tensors and the read
    plain values."""
    tensors = torch.load(os.path.join(path, "tensors.pt"), map_location="cpu",
                         mmap=True, weights_only=True)
    with open(os.path.join(path, "meta.json")) as f:
        flat = {**json.load(f), **tensors}
    if template is None:
        return _nest(flat)
    want = _flat(template)
    missing = sorted(set(want) - set(flat))
    if missing:
        raise KeyError(f"{path} holds no {missing[:8]}")
    out = {}
    with torch.no_grad():
        for k, t in want.items():
            if torch.is_tensor(t):
                t.copy_(flat[k])
                out[k] = t
            else:
                out[k] = flat[k]
    return _nest(out)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``checkpoint-{step}`` directory of the highest step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [d for d in os.listdir(ckpt_dir)
             if d.startswith("checkpoint-") and d.split("-")[-1].isdigit()]
    if not cands:
        return None
    return os.path.join(ckpt_dir, max(cands, key=lambda d: int(d.split("-")[-1])))
