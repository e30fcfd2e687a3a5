"""The SSD half of the vision operators (counterpart of
``incubator_mxnet_tpu/ops/vision.py:78-290``; ref:
src/operator/contrib/multibox_*.cc, contrib/bounding_box.cc).

``MultiBoxPrior``, ``MultiBoxTarget``, ``MultiBoxDetection`` and ``box_nms``,
each also under its ``_contrib_`` name.  As in the JAX build every shape is
static and nothing is read on the host: the batch is one tensor dimension
(the JAX build's ``vmap``), NMS runs a fixed number of iterations (one pick
a step; a step that finds nothing alive picks -1), and hard-negative
mining ranks by a stable sort, so the ops run inside a captured CUDA
graph.  The rest of the JAX file (ROI and PS-ROI pooling, ``Proposal``,
the samplers, ``Correlation``, ``Pad``, ``Crop``) is ROADMAP item 9b.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .registry import register

_NEG = -1e30


def _consts(values, device):
    """f32 constants on ``device`` made there (no host copy, so a graph
    capture may hold them)."""
    return [torch.full((), float(np.float32(v)), dtype=torch.float32,
                       device=device) for v in values]


@register("MultiBoxPrior", num_inputs=1, differentiable=False,
          aliases=("_contrib_MultiBoxPrior",))
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes for one feature map (ref: multibox_prior.cc): (1,
    H·W·(len(sizes) + len(ratios) - 1), 4) in corner format, normalized,
    f32; sizes[0] with every ratio, then the other sizes with ratios[0]."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    ws = [sizes[0] * math.sqrt(r) for r in ratios] + \
        [s * math.sqrt(ratios[0]) for s in sizes[1:]]
    hs = [sizes[0] / math.sqrt(r) for r in ratios] + \
        [s / math.sqrt(ratios[0]) for s in sizes[1:]]
    # rounded to f32 first, then halved (exactly), as the JAX build does
    ws = torch.stack(_consts(ws, dev)) / 2
    hs = torch.stack(_consts(hs, dev)) / 2
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")       # (H, W)
    cxg = cxg.reshape(-1, 1)
    cyg = cyg.reshape(-1, 1)
    boxes = torch.stack([cxg - ws, cyg - hs, cxg + ws, cyg + hs], dim=-1)
    boxes = boxes.reshape(1, h * w * ws.shape[0], 4)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    return boxes


def _box_iou_corner(a, b):
    """IoU between corner boxes (..., N, 4) and (..., M, 4): (..., N, M)."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * \
        (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


@register("MultiBoxTarget", num_inputs=3, differentiable=False,
          num_outputs=3, aliases=("_contrib_MultiBoxTarget",))
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """Assign anchors to ground truth (ref: multibox_target.cc).  ``label``
    is (B, M, 5) [cls, x1, y1, x2, y2], padded with rows of cls -1;
    ``cls_pred`` (B, classes, A).  Returns (loc_target (B, 4A), loc_mask
    (B, 4A), cls_target (B, A)): class + 1 for a matched anchor, 0 for the
    background, ``ignore_label`` for a negative hard-negative mining left
    out.  Each valid ground truth claims its best anchor; an anchor whose
    best IoU reaches the threshold matches too."""
    anchors = anchor.reshape(-1, 4)
    n_anchor = anchors.shape[0]
    var = _consts(variances, anchors.device)
    valid = label[..., 0] >= 0                               # (B, M)
    gt = label[..., 1:5]
    iou = _box_iou_corner(anchors, gt)                       # (B, A, M)
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=2)                               # (B, A)
    best_gt = iou.argmax(dim=2)
    best_anchor = iou.argmax(dim=1)                          # (B, M)
    # each valid gt claims its best anchor (an invalid row claims none)
    claims = (best_anchor[:, None, :] ==
              torch.arange(n_anchor, device=anchors.device)[None, :, None])
    forced = (claims & valid[:, None, :]).any(dim=2)
    pos = forced | (best_iou >= overlap_threshold)
    idx = best_gt[..., None].expand(-1, -1, 4)
    matched = torch.gather(gt, 1, idx)                       # (B, A, 4)
    cls_of = torch.gather(label[..., 0], 1, best_gt)
    cls = torch.where(pos, cls_of + 1, torch.zeros_like(cls_of))
    if negative_mining_ratio > 0:
        # hard negatives (multibox_target.cc:216): unmatched anchors whose
        # best IoU stays below the threshold compete for ratio x positives
        # (at least the minimum) background slots, lowest background
        # probability first, ties in anchor order; every other negative is
        # marked ignore_label
        neg = ~pos
        bg_prob = torch.softmax(cls_pred, dim=1)[:, 0]       # (B, A)
        cand = neg & (best_iou < negative_mining_thresh)
        num_keep = torch.clamp(
            negative_mining_ratio * pos.sum(dim=1).to(torch.float32),
            min=float(minimum_negative_samples))
        score = torch.where(cand, -bg_prob,
                            torch.full_like(bg_prob, -math.inf))
        order = torch.argsort(-score, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n_anchor, device=order.device)
            .expand_as(order).contiguous())
        keep_neg = cand & (rank < num_keep[:, None])
        cls = torch.where(neg & ~keep_neg,
                          torch.full_like(cls, ignore_label), cls)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    gw = (matched[..., 2] - matched[..., 0]).clamp(min=1e-8)
    gh = (matched[..., 3] - matched[..., 1]).clamp(min=1e-8)
    gcx = (matched[..., 0] + matched[..., 2]) / 2
    gcy = (matched[..., 1] + matched[..., 3]) / 2
    tx = (gcx - acx) / aw.clamp(min=1e-8) / var[0]
    ty = (gcy - acy) / ah.clamp(min=1e-8) / var[1]
    tw = torch.log(gw / aw.clamp(min=1e-8)) / var[2]
    th = torch.log(gh / ah.clamp(min=1e-8)) / var[3]
    loc_t = torch.stack([tx, ty, tw, th], dim=-1)            # (B, A, 4)
    loc_t = torch.where(pos[..., None], loc_t, torch.zeros_like(loc_t))
    loc_m = pos[..., None].expand(-1, -1, 4).to(torch.float32)
    b = label.shape[0]
    return loc_t.reshape(b, -1), loc_m.reshape(b, -1), cls


def _nms_fixed(boxes, scores, iou_threshold, max_out):
    """NMS with a fixed trip count over a batch: (B, N, 4) corner boxes
    and (B, N) scores (``_NEG`` for none) to (B, max_out) indices, -1
    padded.  Each step picks the highest score alive (the first of equal
    ones) and suppresses every box overlapping it by ``iou_threshold`` or
    more, itself included."""
    iou = _box_iou_corner(boxes, boxes)                      # (B, N, N)
    rows = torch.arange(scores.shape[0], device=scores.device)
    neg = torch.full_like(scores, _NEG)
    none = torch.full_like(rows, -1)
    picked = []
    alive = scores
    for _ in range(max_out):
        best = alive.argmax(dim=1)                           # (B,)
        valid = alive[rows, best] > _NEG / 2
        picked.append(torch.where(valid, best, none))
        suppress = iou[rows, best] >= iou_threshold          # (B, N)
        new = torch.where(suppress, neg, alive)
        new = new.scatter(1, best[:, None], _NEG)
        alive = torch.where(valid[:, None], new, alive)
    if not picked:
        return torch.empty((scores.shape[0], 0), dtype=torch.long,
                           device=scores.device)
    return torch.stack(picked, dim=1)


@register("MultiBoxDetection", num_inputs=3, differentiable=False,
          aliases=("_contrib_MultiBoxDetection",))
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                        background_id=0, nms_threshold=0.5,
                        force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                        nms_topk=-1):
    """Decode and NMS (ref: multibox_detection.cc): (B, A, 6) rows [class
    id, score, x1, y1, x2, y2] in the order NMS picked them, -1 rows after.
    The class id counts the foreground classes (the background left out);
    a score not above ``threshold`` is never picked."""
    b, _, n_anchor = cls_prob.shape
    anchors = anchor.reshape(-1, 4)
    var = _consts(variances, anchors.device)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    topk = n_anchor if nms_topk <= 0 else min(nms_topk, n_anchor)
    loc = loc_pred.reshape(b, -1, 4)
    cx = loc[..., 0] * var[0] * aw + acx
    cy = loc[..., 1] * var[1] * ah + acy
    w = torch.exp(loc[..., 2] * var[2]) * aw / 2
    h = torch.exp(loc[..., 3] * var[3]) * ah / 2
    boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1)
    score = fg.amax(dim=1)                                   # (B, A)
    cls_id = fg.argmax(dim=1)
    score = torch.where(score > threshold, score, torch.full_like(score,
                                                                  _NEG))
    keep = _nms_fixed(boxes, score, nms_threshold, topk)     # (B, topk)
    sel = keep.clamp(min=0)
    valid = keep >= 0
    s_sel = torch.gather(score, 1, sel)
    entries = torch.cat([
        torch.gather(cls_id, 1, sel).to(torch.float32)[..., None],
        torch.where(s_sel > _NEG / 2, s_sel, torch.zeros_like(s_sel))[
            ..., None],
        torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4))], dim=-1)
    entries = torch.where(valid[..., None], entries,
                          torch.full_like(entries, -1.0))
    out = torch.full((b, n_anchor, 6), -1.0, dtype=entries.dtype,
                     device=entries.device)
    out[:, :topk] = entries
    return out


@register("box_nms", num_inputs=1, differentiable=False,
          aliases=("_contrib_box_nms",))
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1, force_suppress=True,
             in_format="corner", out_format="corner"):
    """NMS over (..., N, K) rows (ref: contrib/bounding_box.cc): the rows
    NMS keeps, in the order it picked them, then rows of -1.  Like the JAX
    build, every box competes with every other (``id_index`` and
    ``force_suppress`` are not read) and rows keep their input format."""
    shape = data.shape
    flat = data.reshape(-1, shape[-2], shape[-1])
    n = shape[-2]
    max_out = n if topk <= 0 else min(topk, n)
    boxes = flat[..., coord_start:coord_start + 4]
    if in_format == "center":
        cx, cy, w, h = (boxes[..., i] for i in range(4))
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                            dim=-1)
    scores = flat[..., score_index]
    scores = torch.where(scores > valid_thresh, scores,
                         torch.full_like(scores, _NEG))
    keep = _nms_fixed(boxes, scores, overlap_thresh, max_out)
    sel = keep.clamp(min=0)
    rows = torch.gather(flat, 1, sel[..., None].expand(-1, -1, shape[-1]))
    rows = torch.where((keep >= 0)[..., None], rows,
                       torch.full_like(rows, -1.0))
    out = torch.full_like(flat, -1.0)
    out[:, :max_out] = rows
    return out.reshape(shape)
