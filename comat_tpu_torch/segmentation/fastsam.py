"""FastSAM (YOLOv8-seg): the mask-proposal model, and its host decode.

Port of comat_tpu/segmentation/fastsam.py (`YoloSegConfig`, `ConvBNSiLU`,
`Bottleneck`, `C2f`, `SPPF`, `_upsample2`, `YoloV8Seg`,
`decode_predictions`, `_nms`, `box_prompt_masks`). The reference runs
ultralytics' FastSAM-x for segment-everything proposals and picks each
noun's mask by box prompt (attr_concen_utils/gsam_interface.py:24-28,
64-74, 111-137). Geometry is (depth, width, ratio), so FastSAM-x and the
tiny test config share the code.

The model is NCHW inside; it takes and returns NHWC as JAX does (image
(B, H, W, 3); per level {"box", "cls", "mc"} (B, h, w, ·) fp32 and
protos (B, H/4, W/4, num_masks) fp32). Parameter names are ultralytics'
(`model.{idx}...`, the yolov8-seg yaml's layer indices: backbone 0-9,
neck 12-21, the Segment head 22 with cv2 box, cv3 class and cv4 mask
coefficient branches and `proto`), so FastSAM-x.pt loads with
`load_state_dict`. BatchNorm runs on its running statistics, eps 1e-3.

The host decode is numpy, a copy of JAX's (NMS is written out, so the
port needs no torchvision). `box_prompt_masks` counts each proposal's
pixels inside the query box with a summed-area table instead of a mask
product per proposal (the same integer counts, so the same IoUs and
choice), and resizes as jax.image.resize's "nearest" does (half-pixel
centres, float32 source coordinates).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from comat_tpu_torch.segmentation.layers import BatchNorm2d, Conv2d


@dataclasses.dataclass(frozen=True)
class YoloSegConfig:
    depth: float = 1.0       # block repeats multiplier
    width: float = 1.25      # channel multiplier
    max_channels: int = 512
    num_classes: int = 1     # FastSAM: a single "object" class
    num_masks: int = 32      # mask coefficients
    reg_max: int = 16        # DFL bins
    dtype: torch.dtype = torch.bfloat16

    def ch(self, c: int) -> int:
        return int(min(c, self.max_channels) * self.width)

    def n(self, n: int) -> int:
        return max(1, round(n * self.depth))

    @staticmethod
    def fastsam_x() -> "YoloSegConfig":
        return YoloSegConfig()

    @staticmethod
    def tiny() -> "YoloSegConfig":
        return YoloSegConfig(depth=0.34, width=0.125, max_channels=256, num_masks=8,
                             reg_max=4, dtype=torch.float32)


class ConvBNSiLU(nn.Module):
    """ultralytics Conv: conv (no bias), bn, SiLU."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(c_in, c_out, k, stride=s, padding=k // 2, bias=False, dtype=dtype)
        self.bn = BatchNorm2d(c_out, eps=1e-3, dtype=dtype)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool, dtype):
        super().__init__()
        self.shortcut = shortcut
        self.cv1 = ConvBNSiLU(c, c, 3, dtype=dtype)
        self.cv2 = ConvBNSiLU(c, c, 3, dtype=dtype)

    def forward(self, x):
        h = self.cv2(self.cv1(x))
        return x + h if self.shortcut else h


class C2f(nn.Module):
    def __init__(self, c_in: int, c_out: int, n: int, shortcut: bool, dtype):
        super().__init__()
        self.c = c_out // 2
        self.cv1 = ConvBNSiLU(c_in, 2 * self.c, 1, dtype=dtype)
        self.m = nn.ModuleList([Bottleneck(self.c, shortcut, dtype) for _ in range(n)])
        self.cv2 = ConvBNSiLU((2 + n) * self.c, c_out, 1, dtype=dtype)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, :self.c], y[:, self.c:]]
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    def __init__(self, c_in: int, c_out: int, dtype):
        super().__init__()
        c = c_in // 2
        self.cv1 = ConvBNSiLU(c_in, c, 1, dtype=dtype)
        self.cv2 = ConvBNSiLU(4 * c, c_out, 1, dtype=dtype)

    def forward(self, x):
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, stride=1, padding=2))
        return self.cv2(torch.cat(pools, dim=1))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 (NCHW): each pixel repeated, as jax.image.resize's
    nearest does at an integer ratio."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class Proto(nn.Module):
    def __init__(self, c_in: int, c: int, nm: int, dtype):
        super().__init__()
        self.cv1 = ConvBNSiLU(c_in, c, 3, dtype=dtype)
        self.upsample = nn.ConvTranspose2d(c, c, 2, stride=2)
        self.cv2 = ConvBNSiLU(c, c, 3, dtype=dtype)
        self.cv3 = ConvBNSiLU(c, nm, 1, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        dt, up = self.compute_dtype, self.upsample
        x = F.conv_transpose2d(self.cv1(x).to(dt), up.weight.to(dt), up.bias.to(dt), stride=2)
        return self.cv3(self.cv2(x))


def _branch(c_in: int, c: int, c_out: int, dtype) -> nn.Sequential:
    return nn.Sequential(ConvBNSiLU(c_in, c, 3, dtype=dtype), ConvBNSiLU(c, c, 3, dtype=dtype),
                         Conv2d(c, c_out, 1, dtype=torch.float32))


class Segment(nn.Module):
    """ultralytics' Segment head: per level a box (cv2), class (cv3) and
    mask-coefficient (cv4) branch, widths from the first level's channels;
    the proto masks from the first level."""

    def __init__(self, cfg: YoloSegConfig, chans: Sequence[int]):
        super().__init__()
        dt, ch0 = cfg.dtype, chans[0]
        c2 = max(16, ch0 // 4, cfg.reg_max * 4)
        c3 = max(ch0, min(cfg.num_classes, 100))
        c4 = max(ch0 // 4, cfg.num_masks)
        self.cv2 = nn.ModuleList([_branch(c, c2, 4 * cfg.reg_max, dt) for c in chans])
        self.cv3 = nn.ModuleList([_branch(c, c3, cfg.num_classes, dt) for c in chans])
        self.cv4 = nn.ModuleList([_branch(c, c4, cfg.num_masks, dt) for c in chans])
        self.proto = Proto(ch0, cfg.ch(256), cfg.num_masks, dt)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).float()


class YoloV8Seg(nn.Module):
    """image (B, H, W, 3) -> ([{"box", "cls", "mc"} per level at strides
    8/16/32], protos)."""

    def __init__(self, cfg: YoloSegConfig):
        super().__init__()
        self.cfg = cfg
        ch, n, dt = cfg.ch, cfg.n, cfg.dtype
        layers = {
            0: ConvBNSiLU(3, ch(64), 3, 2, dt),
            1: ConvBNSiLU(ch(64), ch(128), 3, 2, dt),
            2: C2f(ch(128), ch(128), n(3), True, dt),
            3: ConvBNSiLU(ch(128), ch(256), 3, 2, dt),
            4: C2f(ch(256), ch(256), n(6), True, dt),
            5: ConvBNSiLU(ch(256), ch(512), 3, 2, dt),
            6: C2f(ch(512), ch(512), n(6), True, dt),
            7: ConvBNSiLU(ch(512), ch(512), 3, 2, dt),
            8: C2f(ch(512), ch(512), n(3), True, dt),
            9: SPPF(ch(512), ch(512), dt),
            12: C2f(2 * ch(512), ch(512), n(3), False, dt),
            15: C2f(ch(512) + ch(256), ch(256), n(3), False, dt),
            16: ConvBNSiLU(ch(256), ch(256), 3, 2, dt),
            18: C2f(ch(256) + ch(512), ch(512), n(3), False, dt),
            19: ConvBNSiLU(ch(512), ch(512), 3, 2, dt),
            21: C2f(2 * ch(512), ch(512), n(3), False, dt),
            22: Segment(cfg, (ch(256), ch(512), ch(512))),
        }
        self.model = nn.ModuleDict({str(i): m for i, m in layers.items()})

    def forward(self, image: torch.Tensor):
        m = self.model
        x = image.permute(0, 3, 1, 2).to(self.cfg.dtype)
        x = m["2"](m["1"](m["0"](x)))
        p3 = m["4"](m["3"](x))
        p4 = m["6"](m["5"](p3))
        p5 = m["9"](m["8"](m["7"](p4)))
        u4 = m["12"](torch.cat([_upsample2(p5), p4], dim=1))
        u3 = m["15"](torch.cat([_upsample2(u4), p3], dim=1))
        d4 = m["18"](torch.cat([m["16"](u3), u4], dim=1))
        d5 = m["21"](torch.cat([m["19"](d4), p5], dim=1))
        head = m["22"]
        protos = _nhwc(head.proto(u3))
        outs = [{"box": _nhwc(head.cv2[i](f)), "cls": _nhwc(head.cv3[i](f)),
                 "mc": _nhwc(head.cv4[i](f))} for i, f in enumerate((u3, d4, d5))]
        return outs, protos


@torch.no_grad()
def calibrate_batchnorm_(model: nn.Module, image: torch.Tensor) -> None:
    """Set each BatchNorm's running statistics to those of its own input
    (over batch and pixels) in one forward of `image`, layer by layer, as a
    trained model's statistics normalise its activations. Seeded weights
    need it: with unit running variances the activations shrink layer by
    layer through YOLOv8's depth until the heads' logits round to zero and
    every proposal mask is empty."""

    def hook(bn, args):
        var, mean = torch.var_mean(args[0].float(), dim=(0, 2, 3), unbiased=False)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm2d)]
    try:
        model(image)
    finally:
        for h in handles:
            h.remove()


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def decode_predictions(outs, protos, cfg: YoloSegConfig, conf_thresh: float = 0.4,
                       iou_thresh: float = 0.9, max_det: int = 100
                       ) -> List[Dict[str, np.ndarray]]:
    """DFL box integral, NMS and mask assembly, per image: {boxes (N, 4)
    xyxy px, scores (N,), masks (N, H/4, W/4) bool, sat: the masks'
    `summed_area`} (ultralytics' postprocess and FastSAM's everything
    results, gsam_interface.py:64-74). Outputs may be tensors or arrays."""
    nm, reg = cfg.num_masks, cfg.reg_max
    results = []
    protos = to_numpy(protos)
    outs = [{k: to_numpy(v) for k, v in o.items()} for o in outs]
    B = protos.shape[0]
    for b in range(B):
        all_boxes, all_scores, all_mc = [], [], []
        for lvl, o in enumerate(outs):
            stride = 8 * 2 ** lvl
            box, cls, mc = o["box"][b], o["cls"][b], o["mc"][b]
            prob = 1.0 / (1.0 + np.exp(-cls))
            ys, xs = np.where(prob.max(-1) > conf_thresh)
            if len(ys) == 0:
                continue
            d = box[ys, xs].reshape(-1, 4, reg)
            d = np.exp(d - d.max(-1, keepdims=True))
            d /= d.sum(-1, keepdims=True)
            dist = (d * np.arange(reg)).sum(-1)  # (N, 4) l, t, r, b
            cx, cy = xs + 0.5, ys + 0.5
            x1 = (cx - dist[:, 0]) * stride
            y1 = (cy - dist[:, 1]) * stride
            x2 = (cx + dist[:, 2]) * stride
            y2 = (cy + dist[:, 3]) * stride
            all_boxes.append(np.stack([x1, y1, x2, y2], -1))
            all_scores.append(prob[ys, xs].max(-1))
            all_mc.append(mc[ys, xs])
        if not all_boxes:
            results.append({"boxes": np.zeros((0, 4)), "scores": np.zeros((0,)),
                            "masks": np.zeros((0,) + protos.shape[1:3])})
            continue
        boxes = np.concatenate(all_boxes)
        scores = np.concatenate(all_scores)
        mcs = np.concatenate(all_mc)
        keep = _nms(boxes, scores, iou_thresh, max_det)
        boxes, scores, mcs = boxes[keep], scores[keep], mcs[keep]
        masks = 1.0 / (1.0 + np.exp(-(protos[b].reshape(-1, nm) @ mcs.T)))  # (hw, N)
        ph, pw = protos.shape[1:3]
        masks = masks.T.reshape(-1, ph, pw)
        for i, (x1, y1, x2, y2) in enumerate(boxes / 4.0):   # proto res is input/4
            m = np.zeros((ph, pw), np.float32)
            xa, xb = max(int(x1), 0), min(int(np.ceil(x2)), pw)
            ya, yb = max(int(y1), 0), min(int(np.ceil(y2)), ph)
            m[ya:yb, xa:xb] = masks[i, ya:yb, xa:xb]
            masks[i] = m
        masks = masks > 0.5
        results.append({"boxes": boxes, "scores": scores, "masks": masks,
                        "sat": summed_area(masks)})
    return results


def _nms(boxes: np.ndarray, scores: np.ndarray, iou: float,
         max_keep: Optional[int] = None) -> np.ndarray:
    """Greedy NMS by descending score. With `max_keep` it stops at that
    many kept boxes: greedy NMS decides its first n keeps from what came
    before them alone, so they are the first n of the full run."""
    order = np.argsort(-scores)
    keep = []
    while len(order):
        i = order[0]
        keep.append(i)
        if len(order) == 1 or len(keep) == max_keep:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        a_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        ious = inter / np.maximum(a_i + a_r - inter, 1e-9)
        order = rest[ious <= iou]
    return np.asarray(keep, np.int64)


def resize_nearest(x: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """jax.image.resize(x, out_hw, "nearest") of a 2-D array: source index
    floor((i + 0.5) * in / out), computed in float32."""
    idx = []
    for m, n in zip(x.shape, out_hw):
        off = (np.arange(n, dtype=np.float32) + 0.5) * np.float32(m) / np.float32(n)
        idx.append(np.floor(off.astype(np.float32)).astype(np.int64))
    return x[idx[0][:, None], idx[1][None, :]]


def summed_area(masks: np.ndarray) -> np.ndarray:
    """(N, h, w) masks -> (N, h + 1, w + 1) summed-area tables (int32)."""
    n, ph, pw = masks.shape
    sat = np.zeros((n, ph + 1, pw + 1), np.int32)
    sat[:, 1:, 1:] = masks.astype(np.int32).cumsum(1).cumsum(2)
    return sat


def _inside_counts(sat: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Per mask, the pixels whose centres lie in the box q = (x1, y1, x2,
    y2), borders included: (m & inside).sum() of box_prompt_masks. Pixel x
    is inside when x + 0.5 >= q0 and x + 0.5 <= q2, bounds exact in fp64."""
    n, ph, pw = sat.shape[0], sat.shape[1] - 1, sat.shape[2] - 1
    xa = max(int(np.ceil(np.float64(q[0]) - 0.5)), 0)
    xb = min(int(np.floor(np.float64(q[2]) - 0.5)), pw - 1) + 1
    ya = max(int(np.ceil(np.float64(q[1]) - 0.5)), 0)
    yb = min(int(np.floor(np.float64(q[3]) - 0.5)), ph - 1) + 1
    if xa >= xb or ya >= yb:
        return np.zeros(n, np.int64)
    return (sat[:, yb, xb].astype(np.int64) - sat[:, ya, xb] - sat[:, yb, xa]
            + sat[:, ya, xa])


def box_prompt_index(result: Dict[str, np.ndarray], query_box_xyxy: Sequence[float],
                     image_hw: Tuple[int, int]) -> Optional[int]:
    """FastSAM box_prompt's choice: the index of the proposal mask with the
    highest IoU against the query box (gsam_interface.py:118-125), None
    without proposals. IoUs in float32, as JAX's loop computes them under
    numpy 2; the first of equal IoUs wins, as its strict `>` picks.
    `result["sat"]` (`summed_area` of the masks), where given, saves
    recounting per query."""
    masks = result["masks"]
    if len(masks) == 0:
        return None
    H, W = image_hw
    ph, pw = masks.shape[1:]
    qx1, qy1, qx2, qy2 = np.asarray(query_box_xyxy, np.float32)
    f32 = np.float32
    q = np.array([qx1 * f32(pw) / f32(W), qy1 * f32(ph) / f32(H),
                  qx2 * f32(pw) / f32(W), qy2 * f32(ph) / f32(H)], np.float32)
    q_area = f32(max((q[2] - q[0]) * (q[3] - q[1]), f32(1e-9)))
    sat = result.get("sat")
    if sat is None:
        sat = summed_area(masks)
    inter = _inside_counts(sat, q).astype(np.float32)
    area = sat[:, ph, pw].astype(np.float32)
    union = (area + q_area) - inter
    return int(np.argmax(inter / np.maximum(union, f32(1e-9))))


def upsample_mask(mask: np.ndarray, image_hw: Tuple[int, int]) -> np.ndarray:
    """A proto-resolution 0/1 mask -> (H, W) float32 0/1."""
    return (resize_nearest(mask.astype(np.float32), image_hw) > 0.5).astype(np.float32)


def box_prompt_masks(result: Dict[str, np.ndarray], query_box_xyxy: Sequence[float],
                     image_hw: Tuple[int, int]) -> np.ndarray:
    """FastSAM box_prompt: the chosen proposal (`box_prompt_index`) as an
    (H, W) float32 0/1 mask upsampled from the proto resolution."""
    best = box_prompt_index(result, query_box_xyxy, image_hw)
    if best is None:
        return np.zeros(image_hw, np.float32)
    return upsample_mask(result["masks"][best], image_hw)
