"""The vision and detection operators (counterpart of
``incubator_mxnet_tpu/ops/vision.py``; ref: src/operator/roi_pooling.cc,
contrib/multibox_*.cc, contrib/bounding_box.cc, contrib/proposal.cc,
bilinear_sampler.cc, grid_generator.cc, spatial_transformer.cc,
correlation.cc, crop.cc, contrib/roi_align.cc, contrib/psroi_pooling.cc,
contrib/deformable_convolution.cc, contrib/deformable_psroi_pooling.cc).

The SSD ops (``MultiBoxPrior``, ``MultiBoxTarget``, ``MultiBoxDetection``,
``box_nms``), ``Proposal``, ROI and position-sensitive ROI pooling,
``ROIAlign``, the deformable convolution and pooling, the samplers
(``BilinearSampler``, ``GridGenerator``, ``SpatialTransformer``),
``Correlation`` and ``Crop``.  As in the JAX build every shape is static
and nothing is read on the host: the batch and the ROIs are tensor
dimensions (the JAX build's ``vmap``), NMS runs a fixed number of
iterations (one pick a step; a step that finds nothing alive picks -1),
and rankings are stable sorts, so every op runs inside a captured CUDA
graph.  Two places compute the JAX build's function another way:

* ROI and position-sensitive ROI pooling mask the whole feature map for
  every ROI and bin in the JAX build, which at Faster R-CNN's width (300
  ROIs x 14 x 14 bins x 1024 channels x a 38 x 63 map) is ~1.4e11
  elements.  Here each bin reads a window of the map bounded by the bin a
  ROI inside the map can have (``ceil(H / bins) + 1`` rows, likewise
  columns), ROIs in chunks; the part of a larger bin past its window (a
  ROI reaching past the map) comes from a range-max table (max) or an
  integral image (average), so memory stays bounded by the output times
  the window for any ROI.
* ``Correlation`` computes only the output pixels the JAX build keeps
  after its crop and stride, in an autograd Function that saves no
  per-displacement product.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError
from ._precision import f32_products, fma_f32
from ._precision import f32_reciprocal as _recip, f32_scalar as _f32
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


# ---------------------------------------------------------------------------
# Shared helpers of the ROI and sampling ops
# ---------------------------------------------------------------------------

# about this many elements in one gathered chunk of ROIs (512 MB of f32)
_CHUNK_ELEMENTS = 1 << 27


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _chunks(total, per_item):
    """Slices of ``range(total)`` of about ``_CHUNK_ELEMENTS`` elements
    each, ``per_item`` elements an item (one slice, maybe empty, at
    least)."""
    step = max(1, _CHUNK_ELEMENTS // max(per_item, 1))
    return [slice(i, min(i + step, total))
            for i in range(0, total, step)] or [slice(0, 0)]


def _batch_index(col, n):
    """A ROI's image as the JAX build's ``data[roi[0].astype(int32)]``
    reads it: truncated toward zero, a negative index counted from the
    end, then clamped into the batch (XLA's gather clamps)."""
    b = col.to(torch.int64)
    b = torch.where(b < 0, b + n, b)
    return b.clamp(0, n - 1)


def _index(coord, size):
    """A float coordinate already clipped to [0, size - 1] as an index
    (NaN, which no clip removes, reads index 0, masked by its caller)."""
    return coord.clamp(0, size - 1).to(torch.int64).clamp(0, size - 1)


def _bilinear(img, gx, gy, b, c=None):
    """``_bilinear_gather`` of the JAX build (vision.py:371-391) over a
    batch: bilinear samples of ``img`` (N, C, H, W) at the pixel
    coordinates ``gx``, ``gy`` of image ``b`` (broadcast together to a
    shape S), each of the four corners outside [0, W-1] x [0, H-1] read as
    0.  Without ``c`` the result is S + (C,), every channel of the pixel
    (one gather of C-vectors from a channels-last copy); with ``c``, the
    channel of each sample, the result has shape S.  The gradient reaches
    ``img`` and, through the fractional weights, the coordinates, as
    autodiff of the JAX function does (floor and the clipped indices carry
    none)."""
    n, ch, h, w = img.shape
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    x1 = x0 + 1
    y1 = y0 + 1
    wx1 = gx - x0
    wy1 = gy - y0
    wx0 = 1 - wx1
    wy0 = 1 - wy1
    if c is None:
        flat = img.permute(0, 2, 3, 1).reshape(n * h * w, ch)
        plane = b * (h * w)
    else:
        flat = img.reshape(-1)
        plane = (b * ch + c) * (h * w)

    def at(y, x):
        inb = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
        v = flat[plane + _index(y, h) * w + _index(x, w)]
        return torch.where(inb[..., None] if c is None else inb, v,
                           _zero(flat))

    def wt(t):
        return t if c is not None else t[..., None]

    return (at(y0, x0) * wt(wy0 * wx0) + at(y0, x1) * wt(wy0 * wx1) +
            at(y1, x0) * wt(wy1 * wx0) + at(y1, x1) * wt(wy1 * wx1))


def _clipped_bins(lo, hi, size):
    """Float bin edges ``[lo, hi)`` as integer row ranges inside
    ``[0, size)``."""
    def cut(v):
        return v.clamp(0, size).to(torch.int64).clamp(0, size)
    return cut(lo), cut(hi)


def _window(lo, hi, k, size):
    """``k`` rows from ``lo`` (..., k), each marked valid below ``hi``, and
    clipped into the map."""
    rows = lo[..., None] + torch.arange(k, device=lo.device)
    return rows.clamp(max=size - 1), rows < hi[..., None]


def _levels(n):
    """floor(log2(n)) + 1: the levels of a range table over ``n`` rows."""
    return max(int(n).bit_length(), 1)


def _log2_floor(length, levels):
    """floor(log2(length)) of positive integer lengths, elementwise."""
    k = torch.zeros_like(length)
    for a in range(1, levels):
        k = k + ((length >> a) > 0).to(k.dtype)
    return k


def _range_max_table(hwc):
    """Maxima over every aligned power-of-two rectangle of a channels-last
    map (N, H, W, C): level (a, b) holds at (y, x) the max over rows [y, y
    + 2^a) and columns [x, x + 2^b), padded with -inf to (H, W); the levels
    are stacked, flattened to (La·Lb·N·H·W, C).  A max over any rectangle
    is the max of four lookups (a range-max query), for the rectangles
    that reach past a window."""
    n, h, w, c = hwc.shape
    la, lb = _levels(h), _levels(w)
    neg = torch.full((), -math.inf, dtype=hwc.dtype, device=hwc.device)

    def shifted(t, dim, by):
        """``t`` moved ``by`` rows toward 0 along ``dim``, -inf behind."""
        by = min(by, t.shape[dim])
        shape = list(t.shape)
        shape[dim] = by
        return torch.cat([t.narrow(dim, by, t.shape[dim] - by),
                          neg.expand(shape)], dim)

    rows = [hwc]
    for a in range(1, la):
        rows.append(torch.maximum(rows[-1], shifted(rows[-1], 1,
                                                    1 << (a - 1))))
    table = []
    for r in rows:
        cols = [r]
        for b in range(1, lb):
            cols.append(torch.maximum(cols[-1], shifted(cols[-1], 2,
                                                        1 << (b - 1))))
        table.extend(cols)
    return torch.stack(table).reshape(-1, c), (la, lb, n, h, w)


def _range_max(table, dims, b, y0, y1, x0, x1):
    """Max over rows [y0, y1) and columns [x0, x1) of image ``b`` (each an
    integer tensor of one shape S, the rectangles non-empty where used):
    S + (C,)."""
    la, lb, n, h, w = dims
    ka = _log2_floor((y1 - y0).clamp(min=1), la)
    kb = _log2_floor((x1 - x0).clamp(min=1), lb)
    ya = y0.clamp(0, h - 1)
    one = torch.ones((), dtype=ka.dtype, device=ka.device)
    yb = (y1 - (one << ka)).clamp(0, h - 1)
    xa = x0.clamp(0, w - 1)
    xb = (x1 - (one << kb)).clamp(0, w - 1)
    base = (ka * lb + kb) * n + b

    def at(y, x):
        return table[(base * h + y) * w + x]

    return torch.maximum(torch.maximum(at(ya, xa), at(ya, xb)),
                         torch.maximum(at(yb, xa), at(yb, xb)))


# ---------------------------------------------------------------------------
# ROI pooling (ref: src/operator/roi_pooling.cc; vision.py:32-71)
# ---------------------------------------------------------------------------

@register("ROIPooling", num_inputs=2, nograd_inputs=(1,))
def _roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Max-pool each ROI [batch index, x1, y1, x2, y2] to ``pooled_size``
    bins: (R, C, ph, pw).  The ROI's corners are scaled and rounded half
    to even (``jnp.round``; ``torch.round`` rounds so too, the registry's
    ``round`` does not), each bin covers the rows floor(y1 + i·bin_h) to
    ceil(y1 + (i+1)·bin_h) inside the map, and a bin with no cell of the
    map gives 0.  Each bin reads a window of ``ceil(H/ph) + 1`` rows and
    ``ceil(W/pw) + 1`` columns (the largest bin of a ROI inside the map)
    with -1e30 in its cells outside the bin, as the JAX build's mask puts
    it; a larger bin (a ROI reaching past the map) takes the rest from a
    range-max table.  The gradient goes to each bin's maxima, split evenly
    among equal ones (``amax``, as ``jnp.max``)."""
    n, c, h, w = data.shape
    ph, pw = (int(v) for v in pooled_size)
    dev = data.device
    n_roi = rois.shape[0]
    scale = _f32(spatial_scale, dev)
    b = _batch_index(rois[:, 0], n)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale) for i in (1, 2, 3, 4))
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    bin_h = rh * _recip(ph, dev)
    bin_w = rw * _recip(pw, dev)
    iy = torch.arange(ph, dtype=torch.float32, device=dev)
    ix = torch.arange(pw, dtype=torch.float32, device=dev)
    ylo, yhi = _clipped_bins(
        torch.floor(fma_f32(iy, bin_h[:, None], y1[:, None])),
        torch.ceil(fma_f32(iy + 1, bin_h[:, None], y1[:, None])), h)
    xlo, xhi = _clipped_bins(
        torch.floor(fma_f32(ix, bin_w[:, None], x1[:, None])),
        torch.ceil(fma_f32(ix + 1, bin_w[:, None], x1[:, None])), w)
    kh = min(h, -(-h // ph) + 1)
    kw = min(w, -(-w // pw) + 1)
    hwc = data.permute(0, 2, 3, 1).reshape(n * h * w, c)
    table = None
    if kh < h or kw < w:
        table, dims = _range_max_table(hwc.reshape(n, h, w, c))
    neg = torch.full((), _NEG, dtype=data.dtype, device=dev)
    outs = []
    for sl in _chunks(n_roi, ph * pw * kh * kw * c):
        ry, vy = _window(ylo[sl], yhi[sl], kh, h)           # (r, ph, kh)
        rx, vx = _window(xlo[sl], xhi[sl], kw, w)           # (r, pw, kw)
        bb = b[sl][:, None, None, None, None]
        pix = (bb * h + ry[:, :, None, :, None]) * w + rx[:, None, :, None, :]
        valid = vy[:, :, None, :, None] & vx[:, None, :, None, :]
        m = torch.where(valid[..., None], hwc[pix], neg).amax(dim=(3, 4))
        y0, y1_ = ylo[sl][:, :, None], yhi[sl][:, :, None]   # (r, ph, 1)
        x0, x1_ = xlo[sl][:, None, :], xhi[sl][:, None, :]   # (r, 1, pw)
        if table is not None:
            # the rows past the window (every column of the bin), then the
            # window's rows in the columns past it
            bb = b[sl][:, None, None]
            ymid = torch.minimum(y1_, y0 + kh)
            for (r0, r1, c0, c1) in ((y0 + kh, y1_, x0, x1_),
                                     (y0, ymid, x0 + kw, x1_)):
                some = (r1 > r0) & (c1 > c0)
                rest = _range_max(table, dims, bb, r0, r1, c0, c1)
                m = torch.where(some[..., None], torch.maximum(m, rest), m)
        empty = (y1_ <= y0) | (x1_ <= x0)
        outs.append(torch.where(empty[..., None], _zero(m), m))
    return torch.cat(outs).permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------------------------
# Proposal (ref: src/operator/contrib/proposal.cc; vision.py:291-363)
# ---------------------------------------------------------------------------

def _base_anchors(feature_stride, scales, ratios):
    """MXNet's GenerateAnchors (proposal.cc): for each ratio, then each
    scale, a box centred in the first stride cell, in f32, as the JAX
    build rounds it (numpy's round, half to even, in f64)."""
    base = feature_stride
    ctr = (base - 1) / 2.0
    out = []
    for r in ratios:
        w0 = np.round(np.sqrt(base * base / r))
        h0 = np.round(w0 * r)
        for s in scales:
            ws, hs = w0 * s, h0 * s
            out.append([ctr - (ws - 1) / 2, ctr - (hs - 1) / 2,
                        ctr + (ws - 1) / 2, ctr + (hs - 1) / 2])
    return np.asarray(out, np.float32)


def _exp_f32(x):
    """exp of f32 values, correctly rounded to f32 (f64 exp, then one
    rounding): CUDA's ``expf`` and the CPU's differ by an ulp at some
    inputs, and NMS is discontinuous (an ulp can flip an IoU at the
    threshold), so the card's kept ROIs must come from the same boxes as
    the CPU's."""
    return torch.exp(x.to(torch.float64)).to(torch.float32)


@register("Proposal", num_inputs=3, differentiable=False,
          fnum_outputs=lambda p: 2 if p.get("output_score") else 1,
          aliases=("_contrib_Proposal", "_contrib_MultiProposal",
                   "MultiProposal"))
def _proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
              rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
              scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
              output_score=False, iou_loss=False):
    """RPN proposals (ref: contrib/proposal.cc): for each image the anchors
    of every position shifted by ``bbox_pred``, clipped to ``im_info``
    (height, width, scale), those narrower or lower than ``rpn_min_size``
    x scale scored -1e30, the ``rpn_pre_nms_top_n`` best kept (a stable
    descending sort: equal scores in anchor order, as ``lax.top_k``), NMS
    at ``threshold`` picking ``rpn_post_nms_top_n`` (a fixed trip count;
    slots NMS leaves are zero boxes).  The size offsets' ``exp`` is
    correctly rounded on every device (:func:`_exp_f32`).  Returns (B·post, 5) ROIs [batch
    index, x1, y1, x2, y2], and with ``output_score`` their (B·post, 1)
    scores.  ``iou_loss`` is read by neither package: the deltas are
    always decoded as center and log-size offsets."""
    b, a2, h, w = cls_prob.shape
    n_a = a2 // 2
    dev = cls_prob.device
    base = _base_anchors(feature_stride, scales, ratios)
    base_t = torch.stack([torch.stack(_consts(row, dev)) for row in base])
    sx = torch.arange(w, dtype=torch.float32, device=dev) * feature_stride
    sy = torch.arange(h, dtype=torch.float32, device=dev) * feature_stride
    shift_x, shift_y = torch.meshgrid(sx, sy, indexing="xy")
    shifts = torch.stack([shift_x.reshape(-1), shift_y.reshape(-1),
                          shift_x.reshape(-1), shift_y.reshape(-1)], dim=1)
    anchors = (base_t[None] + shifts[:, None]).reshape(-1, 4)
    n_total = anchors.shape[0]
    # foreground scores and deltas in the anchors' (position, anchor) order
    scores = cls_prob[:, n_a:].permute(0, 2, 3, 1).reshape(b, -1)
    d = bbox_pred.reshape(b, n_a, 4, h, w).permute(0, 3, 4, 1, 2) \
        .reshape(b, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    acx = anchors[:, 0] + 0.5 * (aw - 1)
    acy = anchors[:, 1] + 0.5 * (ah - 1)
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    pw = _exp_f32(d[..., 2].clamp(-10, 10)) * aw
    ph = _exp_f32(d[..., 3].clamp(-10, 10)) * ah
    info = im_info.to(torch.float32)
    x_max = (info[:, 1] - 1)[:, None]
    y_max = (info[:, 0] - 1)[:, None]
    zero = _f32(0.0, dev)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi)

    boxes = torch.stack([clip(cx - 0.5 * (pw - 1), x_max),
                         clip(cy - 0.5 * (ph - 1), y_max),
                         clip(cx + 0.5 * (pw - 1), x_max),
                         clip(cy + 0.5 * (ph - 1), y_max)], dim=-1)
    ws = boxes[..., 2] - boxes[..., 0] + 1
    hs = boxes[..., 3] - boxes[..., 1] + 1
    min_size = (rpn_min_size * info[:, 2])[:, None]
    scores = torch.where((ws >= min_size) & (hs >= min_size),
                         scores.to(torch.float32),
                         torch.full((), _NEG, device=dev))
    pre = min(rpn_pre_nms_top_n, n_total)
    top_scores, order = torch.sort(scores, dim=1, descending=True,
                                   stable=True)
    top_scores, order = top_scores[:, :pre], order[:, :pre]
    top_boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    keep = _nms_fixed(top_boxes, top_scores, threshold, rpn_post_nms_top_n)
    sel = keep.clamp(min=0)
    valid = (keep >= 0)
    out_boxes = torch.where(valid[..., None], torch.gather(
        top_boxes, 1, sel[..., None].expand(-1, -1, 4)), zero)
    out_scores = torch.where(valid, torch.gather(top_scores, 1, sel), zero)
    batch_idx = torch.arange(b, dtype=torch.float32, device=dev) \
        .repeat_interleave(rpn_post_nms_top_n)
    rois = torch.cat([batch_idx[:, None], out_boxes.reshape(-1, 4)], dim=1)
    if output_score:
        return rois, out_scores.reshape(-1, 1)
    return rois


# ---------------------------------------------------------------------------
# Sampling ops (ref: bilinear_sampler.cc, grid_generator.cc,
# spatial_transformer.cc; vision.py:394-442)
# ---------------------------------------------------------------------------

@register("BilinearSampler", num_inputs=2)
def _bilinear_sampler(data, grid):
    """Sample ``data`` (B, C, H, W) at ``grid`` (B, 2, Ho, Wo) of x and y in
    [-1, 1] (ref: bilinear_sampler.cc), zero outside the map: (B, C, Ho,
    Wo), differentiable in both."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1) * (w - 1) / 2
    gy = (grid[:, 1] + 1) * (h - 1) / 2
    bi = torch.arange(n, device=data.device)[:, None, None]
    return _bilinear(data, gx, gy, bi).permute(0, 3, 1, 2).contiguous()


def _unit_linspace(num, device):
    """``jnp.linspace(-1, 1, num)`` in f32: -(1 - t) + t at t = i / (num -
    1), then 1 (jax's form, which keeps the end points; XLA may round the
    inner points another way by an ulp)."""
    if num <= 1:
        return torch.full((num,), -1.0, device=device)
    t = torch.arange(num - 1, dtype=torch.float32, device=device) / \
        _f32(num - 1, device)
    return torch.cat([t - (1 - t), torch.ones(1, device=device)])


@register("GridGenerator", num_inputs=1)
def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """A sampling grid (B, 2, H, W) for :func:`_bilinear_sampler` (ref:
    grid_generator.cc): ``affine`` maps the target's [-1, 1] grid by each
    (B, 6) matrix (an f32 product, TF32 off); ``warp`` adds the (B, 2, H,
    W) flow in pixels to each pixel's position and normalizes."""
    dev = data.device
    if transform_type == "affine":
        h, w = (int(v) for v in target_shape)
        gx = _unit_linspace(w, dev)[None, :].expand(h, w).reshape(-1)
        gy = _unit_linspace(h, dev)[:, None].expand(h, w).reshape(-1)
        coords = torch.stack([gx, gy, torch.ones_like(gx)])     # (3, HW)
        with f32_products():
            out = torch.matmul(data.reshape(-1, 2, 3), coords.to(data.dtype))
        return out.reshape(-1, 2, h, w)
    _, _, h, w = data.shape
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    nx = (gx + data[:, 0]) * 2 / _f32(max(w - 1, 1), dev) - 1
    ny = (gy + data[:, 1]) * 2 / _f32(max(h - 1, 1), dev) - 1
    return torch.stack([nx, ny], dim=1)


@register("SpatialTransformer", num_inputs=2)
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=False):
    """An affine grid from ``loc`` (B, 6) at ``target_shape``, then the
    bilinear sampler (ref: spatial_transformer.cc)."""
    return _bilinear_sampler(data, _grid_generator(loc, "affine",
                                                   target_shape))


# ---------------------------------------------------------------------------
# Correlation (ref: src/operator/correlation.cc; vision.py:445-467)
# ---------------------------------------------------------------------------

class _CorrelationFunction(torch.autograd.Function):
    """FlowNet's correlation of ``data1`` with ``data2`` over the
    displacements dy, dx in range(-d, d + 1, stride2), as the JAX build
    computes it: both maps padded by ``pad``, the second rolled by (-dy,
    -dx) around the padded map (``jnp.roll`` wraps), the channel mean of
    the product (or of -|difference|), then the padding cropped and every
    ``stride1``-th pixel kept.  Only the kept pixels are computed: output
    pixel (y, x) reads ``data1`` at (y, x) and the padded ``data2`` at ((y
    + pad + dy) mod Hp, (x + pad + dx) mod Wp).  The backward recomputes
    each displacement's gathered map instead of saving 441 of them."""

    @staticmethod
    def _shifts(data2, d, stride1, stride2, pad, h, w):
        dev = data2.device
        hp, wp = h + 2 * pad, w + 2 * pad
        ys = torch.arange(0, h, stride1, device=dev) + pad
        xs = torch.arange(0, w, stride1, device=dev) + pad
        for dy in range(-d, d + 1, stride2):
            for dx in range(-d, d + 1, stride2):
                yield (ys + dy) % hp, (xs + dx) % wp

    @staticmethod
    def forward(ctx, data1, data2, d, stride1, stride2, pad, is_multiply):
        n, c, h, w = data1.shape
        p2 = torch.nn.functional.pad(data2, (pad, pad, pad, pad))
        d1 = data1[:, :, ::stride1, ::stride1]
        outs = []
        for rows, cols in _CorrelationFunction._shifts(
                data2, d, stride1, stride2, pad, h, w):
            s = p2.index_select(2, rows).index_select(3, cols)
            if is_multiply:
                outs.append((d1 * s).mean(dim=1))
            else:
                outs.append(-(d1 - s).abs().mean(dim=1))
        ctx.save_for_backward(data1, data2)
        ctx.conf = (d, stride1, stride2, pad, is_multiply)
        return torch.stack(outs, dim=1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        data1, data2 = ctx.saved_tensors
        d, stride1, stride2, pad, is_multiply = ctx.conf
        n, c, h, w = data1.shape
        p2 = torch.nn.functional.pad(data2, (pad, pad, pad, pad))
        d1 = data1[:, :, ::stride1, ::stride1]
        g1 = torch.zeros_like(d1)
        g2 = torch.zeros_like(p2)
        cnt = _f32(c, grad.device).to(grad.dtype)
        for k, (rows, cols) in enumerate(_CorrelationFunction._shifts(
                data2, d, stride1, stride2, pad, h, w)):
            s = p2.index_select(2, rows).index_select(3, cols)
            gk = (grad[:, k] / cnt)[:, None]
            if is_multiply:
                g1 += gk * s
                g2s = gk * d1
            else:
                sign = torch.sign(d1 - s)
                g1 -= gk * sign
                g2s = gk * sign
            # within one displacement the rows (and the columns) are
            # distinct, so the scatter has no repeated index
            g2[:, :, rows[:, None], cols[None, :]] += g2s
        gd1 = torch.zeros_like(data1)
        gd1[:, :, ::stride1, ::stride1] = g1
        return (gd1, g2[:, :, pad:pad + h, pad:pad + w],
                None, None, None, None, None)


@register("Correlation", num_inputs=2)
def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True):
    """Patch cross-correlation of two feature maps (FlowNet; ref:
    correlation.cc): ((2·(d // stride2) + 1)², ...) channels, one per
    displacement.  The JAX build reads no ``kernel_size``: it correlates
    single pixels, which MXNet computes for ``kernel_size=1``.  The port
    computes that case as the JAX build does and raises for any other
    (ROADMAP, reference-side faults)."""
    if int(kernel_size) != 1:
        raise MXNetError("Correlation: kernel_size=%r is not supported; the "
                         "reference correlates single pixels "
                         "(kernel_size=1)" % (kernel_size,))
    return _CorrelationFunction.apply(data1, data2, int(max_displacement),
                                      int(stride1), int(stride2),
                                      int(pad_size), bool(is_multiply))


@register("Crop", num_inputs=None)
def _crop(*inputs, offset=(0, 0), h_w=(0, 0), num_args=1, center_crop=False):
    """Crop the first input to the second's (H, W) with ``num_args=2``, else
    to ``h_w``, at ``offset`` or centred (ref: src/operator/crop.cc)."""
    data = inputs[0]
    if num_args == 2 and len(inputs) > 1:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = h_w
    h, w = data.shape[2], data.shape[3]
    if center_crop:
        y0, x0 = (h - th) // 2, (w - tw) // 2
    else:
        y0, x0 = offset
    return data[:, :, y0:y0 + th, x0:x0 + tw]


# ---------------------------------------------------------------------------
# ROIAlign (ref: src/operator/contrib/roi_align.cc; vision.py:493-522)
# ---------------------------------------------------------------------------

@register("ROIAlign", num_inputs=2, nograd_inputs=(1,),
          aliases=("_contrib_ROIAlign",))
def _roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
               sample_ratio=2):
    """ROI Align: each bin the mean of ``sample_ratio``² bilinear samples at
    evenly spaced points, the ROI's corners scaled but not rounded: (R, C,
    ph, pw).  ROIs run in chunks."""
    n, c, h, w = data.shape
    ph, pw = (int(v) for v in pooled_size)
    sr = max(int(sample_ratio), 1)
    dev = data.device
    scale = _f32(spatial_scale, dev)
    b = _batch_index(rois[:, 0], n)
    x1, y1, x2, y2 = (rois[:, i] * scale for i in (1, 2, 3, 4))
    bin_h = torch.clamp(y2 - y1, min=1.0) * _recip(ph, dev)
    bin_w = torch.clamp(x2 - x1, min=1.0) * _recip(pw, dev)
    iy = torch.arange(ph * sr, dtype=torch.float32, device=dev)
    ix = torch.arange(pw * sr, dtype=torch.float32, device=dev)
    gy = fma_f32((iy + 0.5) * bin_h[:, None], _recip(sr, dev), y1[:, None])
    gx = fma_f32((ix + 0.5) * bin_w[:, None], _recip(sr, dev), x1[:, None])
    outs = []
    for sl in _chunks(rois.shape[0], ph * sr * pw * sr * c):
        v = _bilinear(data, gx[sl][:, None, :], gy[sl][:, :, None],
                      b[sl][:, None, None])          # (r, ph·sr, pw·sr, C)
        outs.append(v.reshape(-1, ph, sr, pw, sr, c).mean(dim=(2, 4)))
    return torch.cat(outs).permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------------------------
# Deformable convolution, position-sensitive ROI pooling and its deformable
# form (R-FCN, Deformable ConvNets; ref: contrib/deformable_convolution.cc,
# psroi_pooling.cc, deformable_psroi_pooling.cc; vision.py:532-750)
# ---------------------------------------------------------------------------

def _deform_conv_param_shapes(data_shape, params):
    """The offset comes from a sibling convolution, so only weight and bias
    are inferred."""
    nf = params.get("num_filter", 0)
    ng = params.get("num_group", 1)
    kernel = tuple(params.get("kernel", ()))
    return {"weight": (nf, data_shape[1] // ng) + kernel, "bias": (nf,)}


def _deform_argnames(params):
    if params.get("no_bias", False):
        return ("data", "offset", "weight")
    return ("data", "offset", "weight", "bias")


@register("_contrib_DeformableConvolution", num_inputs=None,
          fargnames=_deform_argnames,
          finfer_params=_deform_conv_param_shapes,
          aliases=("DeformableConvolution",))
def _deformable_convolution(*args, kernel=(), stride=(), dilate=(), pad=(),
                            num_filter=0, num_group=1,
                            num_deformable_group=1, workspace=1024,
                            no_bias=False, layout=None):
    """Deformable convolution v1 (ref: deformable_convolution-inl.h).
    ``offset`` has 2·DG·kh·kw channels, [group][tap][y, x], over the
    output grid.  Every tap of every deformable group samples its input
    channels bilinearly at its shifted position (one batched gather), the
    samples form the (C·kh·kw, Ho·Wo) column matrix of each image, and the
    contraction is one f32 product per group (TF32 off), as the JAX
    build's einsum with an f32 result."""
    if no_bias:
        data, offset, weight = args
        bias = None
    else:
        data, offset, weight, bias = args
    n, c, h, w = data.shape
    kh, kw = kernel
    sh, sw = stride if stride else (1, 1)
    dh, dw = dilate if dilate else (1, 1)
    ph, pw = pad if pad else (0, 0)
    ho = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dg, g, taps = num_deformable_group, num_group, kh * kw
    dev = data.device
    base_y = torch.arange(ho, dtype=torch.float32, device=dev) * sh - ph
    base_x = torch.arange(wo, dtype=torch.float32, device=dev) * sw - pw
    ti = torch.tensor([k // kw for k in range(taps)], device=dev)
    tj = torch.tensor([k % kw for k in range(taps)], device=dev)
    off = offset.reshape(n, dg, taps, 2, ho, wo)
    gy = (base_y[:, None] + (ti * dh)[:, None, None]) + off[:, :, :, 0]
    gx = (base_x[None, :] + (tj * dw)[:, None, None]) + off[:, :, :, 1]
    # image of each (sample, deformable group): (N·DG, C/DG, H, W)
    imgs = data.reshape(n * dg, c // dg, h, w)
    bi = torch.arange(n * dg, device=dev).reshape(n, dg, 1, 1, 1)
    col = _bilinear(imgs, gx, gy, bi)            # (N, DG, K, Ho, Wo, C/DG)
    col = col.permute(0, 1, 5, 2, 3, 4).reshape(n, g, (c // g) * taps,
                                                ho * wo)
    wmat = weight.reshape(g, num_filter // g, (c // g) * taps)
    with f32_products():
        out = torch.matmul(wmat.to(torch.float32), col.to(torch.float32))
    out = out.reshape(n, num_filter, ho, wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def _ps_channels(output_dim, k, gs, device):
    """The channel each (class channel, bin row, bin column) pools:
    (ctop·gs + gh)·gs + gw, gh = floor(i·gs / k) clipped (psroi_pooling.cu)."""
    ctop = np.arange(output_dim)[:, None, None]
    gh = np.minimum(np.maximum((np.arange(k) * gs) // k, 0), gs - 1)
    chan = (ctop * gs + gh[None, :, None]) * gs + gh[None, None, :]
    return torch.as_tensor(chan.astype(np.int64), device=device)


def _ps_corners(rois, spatial_scale, shift):
    """PS-ROI corners: the rounded ROI corners (x2, y2 one past) times the
    scale, less ``shift``; then its width and height floored at 0.1."""
    dev = rois.device
    scale = _f32(spatial_scale, dev)
    x1 = torch.round(rois[:, 1]) * scale - shift
    y1 = torch.round(rois[:, 2]) * scale - shift
    x2 = (torch.round(rois[:, 3]) + 1.0) * scale - shift
    y2 = (torch.round(rois[:, 4]) + 1.0) * scale - shift
    return (x1, y1, torch.clamp(x2 - x1, min=0.1),
            torch.clamp(y2 - y1, min=0.1))


def _integral(hw):
    """Zero-led 2-D prefix sums in f64 of (..., H, W): (..., H+1, W+1)."""
    s = hw.to(torch.float64).cumsum(-2).cumsum(-1)
    return torch.nn.functional.pad(s, (1, 0, 1, 0))


@register("_contrib_PSROIPooling", num_inputs=2, nograd_inputs=(1,),
          aliases=("PSROIPooling",))
def _psroi_pooling(data, rois, spatial_scale=1.0, output_dim=0,
                   pooled_size=0, group_size=0):
    """Position-sensitive ROI pooling (ref: psroi_pooling.cu): ``data`` (N,
    output_dim·gs², H, W), out (R, output_dim, k, k); bin (py, px) of class
    channel ``ctop`` averages channel (ctop·gs + gh)·gs + gw over its cells
    (rows floor(py·bin_h + y1) to ceil((py+1)·bin_h + y1) clipped to the
    map), 0 for a bin with none.  Each bin sums a window of ``ceil(H/k) +
    1`` rows and ``ceil(W/k) + 1`` columns; a larger bin takes the rest
    from an f64 integral image of its channel."""
    n, cc, h, w = data.shape
    k = int(pooled_size)
    gs = int(group_size) if group_size else k
    dev = data.device
    chan = _ps_channels(output_dim, k, gs, dev)             # (od, k, k)
    b = _batch_index(rois[:, 0], n)
    x1, y1, rw, rh = _ps_corners(rois, spatial_scale, 0.0)
    bin_h = rh * _recip(k, dev)
    bin_w = rw * _recip(k, dev)
    i = torch.arange(k, dtype=torch.float32, device=dev)
    ylo, yhi = _clipped_bins(
        torch.floor(fma_f32(i, bin_h[:, None], y1[:, None])),
        torch.ceil(fma_f32(i + 1, bin_h[:, None], y1[:, None])), h)
    xlo, xhi = _clipped_bins(
        torch.floor(fma_f32(i, bin_w[:, None], x1[:, None])),
        torch.ceil(fma_f32(i + 1, bin_w[:, None], x1[:, None])), w)
    kh = min(h, -(-h // k) + 1)
    kw = min(w, -(-w // k) + 1)
    flat = data.reshape(-1)
    table = _integral(data) if (kh < h or kw < w) else None
    od = chan.shape[0]
    outs = []
    for sl in _chunks(rois.shape[0], od * k * k * kh * kw):
        ry, vy = _window(ylo[sl], yhi[sl], kh, h)           # (r, k, kh)
        rx, vx = _window(xlo[sl], xhi[sl], kw, w)
        plane = b[sl][:, None, None, None] * cc + chan[None]  # (r, od, k, k)
        idx = ((plane[..., None, None] * h + ry[:, None, :, None, :, None])
               * w + rx[:, None, None, :, None, :])    # (r, od, k, k, kh, kw)
        valid = vy[:, None, :, None, :, None] & vx[:, None, None, :, None, :]
        s = torch.where(valid, flat[idx], _zero(flat)).sum(dim=(4, 5))
        y0, y1_ = ylo[sl][:, None, :, None], yhi[sl][:, None, :, None]
        x0, x1_ = xlo[sl][:, None, None, :], xhi[sl][:, None, None, :]
        if table is not None:
            ii = table.reshape(n * cc, h + 1, w + 1)
            ymid = torch.minimum(y1_, y0 + kh)
            for (r0, r1, c0, c1) in ((y0 + kh, y1_, x0, x1_),
                                     (y0, ymid, x0 + kw, x1_)):
                some = (r1 > r0) & (c1 > c0)
                r0, r1 = r0.clamp(max=h), torch.maximum(r1, r0).clamp(max=h)
                c0, c1 = c0.clamp(max=w), torch.maximum(c1, c0).clamp(max=w)
                rest = (ii[plane, r1, c1] - ii[plane, r0, c1]
                        - ii[plane, r1, c0] + ii[plane, r0, c0])
                s = torch.where(some, s + rest.to(s.dtype), s)
        cnt = ((y1_ - y0).clamp(min=0) * (x1_ - x0).clamp(min=0))
        outs.append(torch.where(cnt > 0, s / cnt.clamp(min=1).to(s.dtype),
                                _zero(s)))
    return torch.cat(outs)


def _dpsroi_argnames(params):
    if params.get("no_trans", False):
        return ("data", "rois")
    return ("data", "rois", "trans")


@register("_contrib_DeformablePSROIPooling", num_inputs=None,
          num_outputs=2, num_visible_outputs=1,
          fargnames=_dpsroi_argnames, nograd_inputs=(1,),
          aliases=("DeformablePSROIPooling",))
def _deformable_psroi_pooling(*args, spatial_scale=1.0, output_dim=0,
                              group_size=0, pooled_size=0, part_size=0,
                              sample_per_part=1, trans_std=0.0,
                              no_trans=False):
    """Deformable position-sensitive ROI pooling (ref:
    deformable_psroi_pooling.cu): each bin's window shifts by its class's
    normalized offset from ``trans`` (R, 2·classes, part, part) times
    ``trans_std`` and the ROI's size; ``sample_per_part``² points are
    sampled bilinearly (clipped into the map, those outside (-0.5, size -
    0.5) left out) and averaged.  Outputs (out (R, output_dim, k, k),
    top_count), the second hidden, as the JAX build's; the clips are
    ``maximum``/``minimum``, as ``jnp.clip``, so a sample exactly on the
    edge splits its gradient as the JAX build's does."""
    if no_trans:
        data, rois = args
        trans = None
    else:
        data, rois, trans = args
    n, cc, h, w = data.shape
    k = int(pooled_size)
    gs = int(group_size) if group_size else k
    part = int(part_size) if part_size else k
    spp = max(int(sample_per_part), 1)
    dev = data.device
    n_cls = 1 if no_trans else trans.shape[1] // 2
    chan = _ps_channels(output_dim, k, gs, dev)             # (od, k, k)
    part_of = torch.as_tensor(np.floor(np.arange(k) / k * part)
                              .astype(np.int64), device=dev)
    class_of = torch.as_tensor((np.arange(output_dim)
                                // (output_dim // n_cls)).astype(np.int64),
                               device=dev)
    b = _batch_index(rois[:, 0], n)
    x1, y1, rw, rh = _ps_corners(rois, spatial_scale, 0.5)
    bin_h = rh * _recip(k, dev)
    bin_w = rw * _recip(k, dev)
    sub_h = bin_h * _recip(spp, dev)
    sub_w = bin_w * _recip(spp, dev)
    r = rois.shape[0]
    if no_trans:
        tx = ty = torch.zeros((r, output_dim, k, k), device=dev)
    else:
        pi = part_of[None, None, :, None]
        pj = part_of[None, None, None, :]
        cls = class_of[None, :, None, None]
        ri = torch.arange(r, device=dev)[:, None, None, None]
        tx = trans[ri, 2 * cls, pi, pj] * trans_std
        ty = trans[ri, 2 * cls + 1, pi, pj] * trans_std
    i = torch.arange(k, dtype=torch.float32, device=dev)
    col = lambda t: t[:, None, None, None]                  # noqa: E731
    hstart = fma_f32(ty, col(rh), fma_f32(i[None, None, :, None],
                                          col(bin_h), col(y1)))
    wstart = fma_f32(tx, col(rw), fma_f32(i[None, None, None, :],
                                          col(bin_w), col(x1)))
    s_i = torch.arange(spp, dtype=torch.float32, device=dev)
    hh = fma_f32(s_i[:, None], col(sub_h)[..., None, None],
                 hstart[..., None, None])
    ww = fma_f32(s_i[None, :], col(sub_w)[..., None, None],
                 wstart[..., None, None])
    hh, ww = torch.broadcast_tensors(hh, ww)       # (R, od, k, k, spp, spp)
    valid = (ww > -0.5) & (ww < w - 0.5) & (hh > -0.5) & (hh < h - 0.5)
    zero = _f32(0.0, dev)
    hs = torch.minimum(torch.maximum(hh, zero), _f32(h - 1.0, dev))
    wsx = torch.minimum(torch.maximum(ww, zero), _f32(w - 1.0, dev))
    vals = _bilinear(data, wsx, hs, b[:, None, None, None, None, None],
                     chan[None, :, :, :, None, None])
    cnt = valid.sum(dim=(4, 5))
    s = torch.where(valid, vals, _zero(vals)).sum(dim=(4, 5))
    out = torch.where(cnt > 0, s / cnt.clamp(min=1).to(s.dtype), _zero(s))
    return out, cnt.to(torch.float32)
