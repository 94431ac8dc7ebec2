"""Grounded-SAM segmenter: GroundingDINO boxes, FastSAM masks.

Port of comat_tpu/segmentation/grounded_sam.py (`GroundedSAMSegmenter`:
`_tokenize_nouns`, the batched path `batch`, `__call__`). It composes as
the reference's GsamSegModel.get_mask does (attr_concen_utils/
gsam_interface.py:54-137): ground ' . '.join(nouns) to boxes, pick each
box's FastSAM proposal by box prompt, and union them per noun; a noun
with no box gets an all-zero mask (:132-133).

Both detectors run frozen, under no_grad, on the segmenter's device; the
image arrives there as a tensor (the presample's decoded image on the
card), so nothing crosses to the host before the forwards. Only their raw
outputs do, for the numpy decode: the boxes and token logits
(`ground_nouns`) and FastSAM's heads and protos (`decode_predictions`,
`box_prompt_index`). GroundingDINO sees the image resized to
`gdino_resize` (bilinear, half-pixel centres, as jax.image.resize
upsamples; the trainer passes 800, the reference's RandomResize([800]))
and ImageNet-normalised; FastSAM sees it at its own size. Weights come
from state dicts in the checkpoints' naming (segmentation/checkpoints.py)
or are drawn from `seed`; with drawn weights the masks are noise.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from comat_tpu_torch import trace
from comat_tpu_torch.models.pipeline import resolve_device
from comat_tpu_torch.segmentation.fastsam import (
    YoloSegConfig,
    YoloV8Seg,
    box_prompt_index,
    calibrate_batchnorm_,
    decode_predictions,
    to_numpy,
    upsample_mask,
)
from comat_tpu_torch.segmentation.gdino import (
    GDinoConfig,
    GroundingDetector,
    build_text_masks,
    cxcywh_to_xyxy,
    ground_nouns,
)
from comat_tpu_torch.weights import init_weights_

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def make_frozen(module_fn, device: torch.device, params: Optional[Mapping] = None,
                seed: int = 0) -> torch.nn.Module:
    """`module_fn()` built on `device`, frozen, in eval mode, holding
    `params` (a state dict in the module's own names) or weights drawn
    from `seed` (`weights.init_weights_`)."""
    with torch.device(device):
        module = module_fn()
    module = module.eval().requires_grad_(False)
    if params is None:
        init_weights_(module, torch.Generator(device=device).manual_seed(seed))
    else:
        module.load_state_dict(params)
    return module


def gdino_input(images01: torch.Tensor, size: Optional[int]) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> GroundingDINO's input: resized to size x
    size (bilinear, align_corners=False, no antialiasing: jax.image.resize's
    bilinear when upsampling) unless None or already that size, then
    ImageNet-normalised; fp32 NHWC."""
    x = images01.float()
    if size and tuple(x.shape[1:3]) != (size, size):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                          align_corners=False, antialias=False).permute(0, 2, 3, 1)
    with trace.sync("segment.image_stats"):
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    with trace.sync("segment.image_stats"):
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


class GroundedSAMSegmenter:
    # masks depend on the generated pixels: the trainer runs the presample
    # and segments its image before the differentiable step
    image_dependent = True

    def __init__(
        self,
        sam_cfg: Optional[YoloSegConfig] = None,
        gdino_cfg: Optional[GDinoConfig] = None,
        tokenizer=None,
        device=None,
        seed: int = 0,
        sam_params: Optional[Mapping[str, torch.Tensor]] = None,
        gdino_params: Optional[Mapping[str, torch.Tensor]] = None,
        box_threshold: float = 0.3,
        text_threshold: float = 0.25,
        gdino_resize: Optional[int] = None,
    ):
        """`device`: CUDA unless the caller says otherwise (asking for CUDA
        without a card raises). `sam_params` / `gdino_params`: state dicts
        of `YoloV8Seg` / `GroundingDetector`; without them the weights are
        drawn from `seed` (FastSAM, its BatchNorm statistics then set from
        one forward of an image drawn from `seed + 2`,
        `fastsam.calibrate_batchnorm_`) and `seed + 1` (GroundingDINO).
        `gdino_resize`: GroundingDINO's input side (None feeds it the
        image as it is, right for the tiny configs)."""
        from comat_tpu_torch.text.tokenizer import HashTokenizer

        self.device = resolve_device(device)
        self.sam_cfg = sam_cfg or YoloSegConfig.fastsam_x()
        self.gdino_cfg = gdino_cfg or GDinoConfig()
        self.tokenizer = tokenizer or HashTokenizer(self.gdino_cfg.text_vocab)
        self.box_threshold = box_threshold
        self.text_threshold = text_threshold
        self.gdino_resize = gdino_resize
        self.sam = make_frozen(lambda: YoloV8Seg(self.sam_cfg), self.device, sam_params, seed)
        if sam_params is None:
            # drawn weights: BatchNorm statistics from a drawn image
            g = torch.Generator(device=self.device).manual_seed(seed + 2)
            calibrate_batchnorm_(self.sam, torch.rand(1, 256, 256, 3, generator=g,
                                                      device=self.device))
        self.gdino = make_frozen(lambda: GroundingDetector(self.gdino_cfg), self.device,
                                 gdino_params, seed + 1)

    def _tokenize_nouns(self, nouns: Sequence[str]):
        """' . '-joined caption and each noun's token span
        (gsam_interface.py:92-100), with GroundingDINO's per-phrase text
        self-attention mask and restarted position ids."""
        text = " . ".join(nouns)
        ids = self.tokenizer.tokenize(text)
        spans = []
        pos = 0
        for noun in nouns:
            n_toks = len(self.tokenizer.tokenize(noun))
            spans.append((pos, pos + n_toks))
            pos += n_toks + 1  # the ' . ' separator token
        sep = getattr(self.tokenizer, "sep_token_id", None)
        if sep is not None:
            ids = ids + [sep]   # terminate the last phrase before the pads
        L = self.gdino_cfg.max_text_len
        ids = (ids + [0] * L)[:L]
        mask = [i < min(pos, L) for i in range(L)]
        ids_np = np.asarray([ids], np.int32)
        period = self.tokenizer.tokenize(".")
        special = {getattr(self.tokenizer, "cls_token_id", -1),
                   getattr(self.tokenizer, "sep_token_id", -1)}
        if len(period) == 1:
            special.add(period[0])
        special.discard(-1)
        self_mask, pos_ids = build_text_masks(ids_np, sorted(special))
        return ids_np, np.asarray([mask], bool), self_mask, pos_ids, spans

    def text_rows(self, nouns_list: Sequence[Sequence[str]], B: int):
        """Per row: (nouns, ids, text mask, self mask, position ids, spans).
        A row without nouns keeps one live token so that attention stays
        defined; it grounds nothing."""
        L = self.gdino_cfg.max_text_len
        rows = []
        for b in range(B):
            nouns = list(nouns_list[b]) if b < len(nouns_list) else []
            if nouns:
                ids, tmask, self_mask, pos_ids, spans = self._tokenize_nouns(nouns)
            else:
                ids = np.zeros((1, L), np.int32)
                tmask = np.zeros((1, L), bool)
                tmask[0, 0] = True
                self_mask, pos_ids = build_text_masks(ids, [])
                spans = []
            rows.append((nouns, ids, tmask, self_mask, pos_ids, spans))
        return rows

    @torch.no_grad()
    def forwards(self, images01: torch.Tensor, rows):
        """The two detectors on the device: ((boxes, token_logits), (outs,
        protos)), still on the device."""
        dev = self.device

        def upload(i):
            with trace.sync("segment.text_upload"):
                return torch.from_numpy(np.concatenate([r[i] for r in rows])).to(dev)

        image = gdino_input(images01, self.gdino_resize)
        text = [upload(i) for i in range(1, 5)]
        boxes, token_logits = self.gdino(image, *text)
        outs, protos = self.sam(images01.float())
        return (boxes, token_logits), (outs, protos)

    def decode_masks(self, rows, boxes_np, logits_np, proposals_all, H: int, W: int
                     ) -> List[List[np.ndarray]]:
        """The host half: per row of `text_rows`, its nouns' (H, W) masks
        from the detectors' outputs as numpy (boxes, token logits) and
        FastSAM's decoded proposals (`decode_predictions`)."""
        result: List[List[np.ndarray]] = []
        for b, (nouns, _, _, _, _, spans) in enumerate(rows):
            if not nouns:
                result.append([])
                continue
            grounded = ground_nouns(boxes_np[b], logits_np[b], spans,
                                    self.box_threshold, self.text_threshold)
            masks: List[np.ndarray] = []
            for ni in range(len(nouns)):
                # the union of the box prompts' upsampled masks; nearest
                # upsampling is a gather, so it is the upsampled union of
                # the chosen proposals, each taken once
                chosen = {box_prompt_index(proposals_all[b], cxcywh_to_xyxy(box, W, H),
                                           (H, W)) for box in grounded.get(ni, [])}
                chosen.discard(None)
                if chosen:
                    union = proposals_all[b]["masks"][sorted(chosen)].any(0)
                    masks.append(upsample_mask(union, (H, W)))
                else:
                    masks.append(np.zeros((H, W), np.float32))
            result.append(masks)
        return result

    def batch(self, images01, nouns_list: Sequence[Sequence[str]]) -> List[List[np.ndarray]]:
        """Segment a batch with one GroundingDINO and one FastSAM call.
        images01 (B, H, W, 3) in [0, 1], a tensor (on any device; moved
        to the segmenter's) or an array. Returns per image one (H, W)
        float32 0/1 mask per noun; an image without nouns gets none. On the
        active clock (`comat_tpu_torch.trace`) the forwards are the span
        "segment.forwards", marked "segment_device" once they are queued,
        before their outputs cross to the host; each copy of an output to
        the host is a sync "segment.wait", and the numpy decode the span
        "segment.decode"."""
        images01 = torch.as_tensor(images01).to(self.device)
        B, H, W, _ = images01.shape
        rows = self.text_rows(nouns_list, B)
        with trace.span("segment.forwards"):
            (boxes, token_logits), (outs, protos) = self.forwards(images01, rows)
        trace.mark("segment_device")

        def fetch(x):
            with trace.sync("segment.wait"):
                return to_numpy(x)

        protos = fetch(protos)
        outs = [{k: fetch(v) for k, v in o.items()} for o in outs]
        boxes, token_logits = fetch(boxes), fetch(token_logits)
        with trace.span("segment.decode"):
            proposals_all = decode_predictions(outs, protos, self.sam_cfg)
            return self.decode_masks(rows, boxes, token_logits, proposals_all, H, W)

    def __call__(self, image01, nouns: Sequence[str]) -> List[np.ndarray]:
        """One image (H, W, 3): its masks, one per noun."""
        if not nouns:
            return []
        return self.batch(torch.as_tensor(image01)[None], [list(nouns)])[0]
