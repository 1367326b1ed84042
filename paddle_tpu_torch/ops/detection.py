"""The SSD detection op kernels: `prior_box`, `iou_similarity`,
`bipartite_match`, `detection_output`, `multibox_loss` and
`detection_map`.

Counterpart of paddle_tpu/ops/detection.py (reference:
paddle/operators/prior_box_op.cc, iou_similarity_op.cc,
bipartite_match_op.cc, detection_output_op.cc; MultiBoxLossLayer.cpp,
DetectionMAPEvaluator.cpp).  `prior_box`, `iou_similarity` and
`multibox_loss` run on the inputs' device; `multibox_loss` is the JAX
op's fixed-shape masked computation (per-prior IoU matching, every gt
forced onto its best prior, variance-encoded smooth L1 on the
positives, softmax cross entropy with 3:1 hard-negative mining), its
ranks an argsort of an argsort, both stable as `jnp.argsort` is, its
argmaxes the first maximum as `jnp.argmax`'s are; its grad is the
generic vjp.  `bipartite_match`, `detection_output` and `detection_map`
are host loops with data-dependent trip counts, as on the JAX side (the
reference runs them on the CPU too): each reads its inputs back to the
host and runs the JAX op's numpy, so `detection_output`'s NMS orders
equal scores by numpy's own sort, and hands its outputs to the inputs'
device.  `_iou_np` serves the NMS and the mAP.
"""

import numpy as np
import torch

from .registry import (device_constant, keep_declared, register_op,
                       values_of)


def _expand_ratios(aspect_ratios, flip):
    """reference: ExpandAspectRatios — 1, then each new ratio (and its
    inverse under `flip`)."""
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    return ars


def prior_half_sizes(attrs):
    """([half widths], [half heights]) of one position's priors, in
    image pixels: per min size, the min size, then sqrt(min * max) with
    a max size, then each aspect ratio other than 1."""
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes") or []]
    ars = _expand_ratios([float(a) for a in
                          attrs.get("aspect_ratios") or [1.0]],
                         bool(attrs.get("flip", True)))
    pw, ph = [], []
    for s, ms in enumerate(min_sizes):
        pw.append(ms / 2.0)
        ph.append(ms / 2.0)
        if max_sizes:
            big = np.sqrt(ms * max_sizes[s])
            pw.append(big / 2.0)
            ph.append(big / 2.0)
        for ar in ars:
            if abs(ar - 1.0) < 1e-6:
                continue
            pw.append(ms * np.sqrt(ar) / 2.0)
            ph.append(ms / np.sqrt(ar) / 2.0)
    return pw, ph


# (map and image sizes, attrs, device) -> (Boxes, Variances): a prior box
# depends on shapes and attrs alone, so each is made once a device (its
# values cross from the host, which on the card waits for the queued
# work) and copied on the device after
_PRIORS = {}


@register_op("prior_box", stop_gradient_op=True,
             nondiff_inputs=("Input", "Image"))
def prior_box(ctx, ins, attrs):
    """reference: prior_box_op.h.  Boxes [H, W, num_priors, 4]: each
    prior of each position of the feature map Input [N, C, H, W] as
    (xmin, ymin, xmax, ymax) normalised by Image's [.., h, w], centred
    at (j + offset, i + offset) steps (a step: the image over the map,
    unless step_w / step_h say), clipped to [0, 1] under `clip`;
    Variances the four variances at each.  In f32, as on the JAX side;
    made once a device and shape (`_PRIORS`), then copied."""
    feat, image = ins["Input"][0], ins["Image"][0]
    h, w = feat.shape[2], feat.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    key = (h, w, img_h, img_w, repr(sorted(attrs.items())),
           str(feat.device))
    if feat.device.type != "meta" and key not in _PRIORS:
        _PRIORS[key] = _priors(feat.device, h, w, img_h, img_w, attrs)
    boxes, var = _PRIORS.get(key) or _priors(feat.device, h, w, img_h,
                                             img_w, attrs)
    return {"Boxes": [boxes.clone()], "Variances": [var.clone()]}


def _priors(dev, h, w, img_h, img_w, attrs):
    variances = [float(v) for v in
                 attrs.get("variances") or [0.1, 0.1, 0.2, 0.2]]
    offset = float(attrs.get("offset", 0.5))
    step_w = float(attrs.get("step_w") or 0.0) or img_w / w
    step_h = float(attrs.get("step_h") or 0.0) or img_h / h
    half_w, half_h = prior_half_sizes(attrs)
    pw = torch.tensor(half_w, dtype=torch.float32, device=dev)
    ph = torch.tensor(half_h, dtype=torch.float32, device=dev)
    n = pw.shape[0]
    cx = ((torch.arange(w, dtype=torch.float32, device=dev) + offset)
          * step_w)[None, :, None]
    cy = ((torch.arange(h, dtype=torch.float32, device=dev) + offset)
          * step_h)[:, None, None]
    corners = [(cx - pw) / img_w, (cy - ph) / img_h, (cx + pw) / img_w,
               (cy + ph) / img_h]
    boxes = torch.stack([c.expand(h, w, n) for c in corners], dim=-1)
    if bool(attrs.get("clip", True)):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variances, dtype=torch.float32,
                       device=dev).expand(h, w, n, 4).contiguous()
    return boxes, var


def _iou(x, y):
    """[N, M] IoU of boxes x [N, 4] and y [M, 4] (xmin, ymin, xmax,
    ymax); 0 where the union is empty."""
    area_x = torch.clamp(x[:, 2] - x[:, 0], min=0) \
        * torch.clamp(x[:, 3] - x[:, 1], min=0)
    area_y = torch.clamp(y[:, 2] - y[:, 0], min=0) \
        * torch.clamp(y[:, 3] - y[:, 1], min=0)
    ix_min = torch.maximum(x[:, None, 0], y[None, :, 0])
    iy_min = torch.maximum(x[:, None, 1], y[None, :, 1])
    ix_max = torch.minimum(x[:, None, 2], y[None, :, 2])
    iy_max = torch.minimum(x[:, None, 3], y[None, :, 3])
    inter = torch.clamp(ix_max - ix_min, min=0) \
        * torch.clamp(iy_max - iy_min, min=0)
    union = area_x[:, None] + area_y[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _iou_np(a, b, floor=1e-12):
    """numpy [N, M] IoU of a [N, 4] and b [M, 4] in their dtype: the JAX
    detection_map's twin of `_iou`, its union floored at `floor` (0 for
    the NMS, where the JAX op runs `_iou` itself)."""
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * \
        np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * \
        np.maximum(b[:, 3] - b[:, 1], 0)
    ix = np.maximum(np.minimum(a[:, None, 2], b[None, :, 2])
                    - np.maximum(a[:, None, 0], b[None, :, 0]), 0)
    iy = np.maximum(np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 1], b[None, :, 1]), 0)
    inter = ix * iy
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, floor), 0.0)


@register_op("iou_similarity", stop_gradient_op=True,
             nondiff_inputs=("X", "Y"))
def iou_similarity(ctx, ins, attrs):
    """reference: iou_similarity_op.h.  Out [N, M]: the IoU of each box
    of X [N, 4] (ragged per image, or dense) with each of Y [M, 4]."""
    x, y = ins["X"][0], ins["Y"][0]
    out = _iou(values_of(x), y)
    return {"Out": [x.with_values(out) if x is not values_of(x) else out]}


def _host(v):
    return values_of(v).detach().cpu().numpy()


@register_op("bipartite_match", jittable=False, stop_gradient_op=True,
             nondiff_inputs=("DistMat",), infer_desc=keep_declared)
def bipartite_match(ctx, ins, attrs):
    """reference: bipartite_match_op.cc BipartiteMatch.  Per image (a
    ragged DistMat's row block, or all of a dense one), greedily the
    largest remaining distance at or above 1e-6 joins its row and
    column, until no row is left: ColToRowMatchIndices int32 [images,
    columns] (-1 unmatched) and ColToRowMatchDis float32; on the host."""
    dist_t = ins["DistMat"][0]
    dist = _host(dist_t)
    if dist_t is not values_of(dist_t):
        splits = dist_t.last_splits().cpu().numpy()
    else:
        splits = np.asarray([0, dist.shape[0]], np.int64)
    n_img, col = len(splits) - 1, dist.shape[1]
    match_indices = np.full((n_img, col), -1, np.int32)
    match_dist = np.zeros((n_img, col), np.float32)
    for i in range(n_img):
        sub = dist[int(splits[i]):int(splits[i + 1])]
        row_pool = list(range(sub.shape[0]))
        while row_pool:
            best = (-1, -1, -1.0)
            for j in range(col):
                if match_indices[i, j] != -1:
                    continue
                for m in row_pool:
                    d = sub[m, j]
                    if d < 1e-6:
                        continue
                    if d > best[2]:
                        best = (m, j, float(d))
            if best[0] < 0:
                break
            m, j, d = best
            match_indices[i, j] = m
            match_dist[i, j] = d
            row_pool.remove(m)
    dev = values_of(dist_t).device
    return {"ColToRowMatchIndices": [torch.from_numpy(match_indices).to(dev)],
            "ColToRowMatchDis": [torch.from_numpy(match_dist).to(dev)]}


def _nms(boxes, scores, nms_threshold, top_k):
    """Greedy NMS of one class (reference: ApplyNMSFast): the kept
    indices, best score first (numpy's argsort of -scores, whose order
    of equal scores the JAX op keeps), each suppressing the later boxes
    whose IoU with it is not at most `nms_threshold`.  The JAX op's loop
    computes a kept box's IoU with the boxes left after it; the IoUs of
    all the candidates are computed here at once, each pair by the same
    arithmetic, so the kept boxes are the same."""
    order = np.argsort(-scores)
    if top_k > 0:
        order = order[:top_k]
    cand = boxes[order]
    iou = _iou_np(cand, cand, floor=0.0)
    suppressed = np.zeros(len(order), bool)
    keep = []
    for pos in range(len(order)):
        if suppressed[pos]:
            continue
        keep.append(int(order[pos]))
        suppressed[pos + 1:] |= ~(iou[pos, pos + 1:] <= nms_threshold)
    return keep


def decode_boxes(loc, pboxes, pvars):
    """[N, P, 4] corners of the center-size, variance-encoded offsets
    loc [N, P, 4] against the priors (numpy, as the JAX op)."""
    pw = pboxes[:, 2] - pboxes[:, 0]
    ph = pboxes[:, 3] - pboxes[:, 1]
    pcx = (pboxes[:, 0] + pboxes[:, 2]) / 2
    pcy = (pboxes[:, 1] + pboxes[:, 3]) / 2
    dcx = pvars[:, 0] * loc[:, :, 0] * pw + pcx
    dcy = pvars[:, 1] * loc[:, :, 1] * ph + pcy
    dw = np.exp(pvars[:, 2] * loc[:, :, 2]) * pw
    dh = np.exp(pvars[:, 3] * loc[:, :, 3]) * ph
    return np.stack([dcx - dw / 2, dcy - dh / 2, dcx + dw / 2,
                     dcy + dh / 2], axis=-1)


@register_op("detection_output", jittable=False, stop_gradient_op=True,
             nondiff_inputs=("Loc", "Conf", "PriorBox"),
             infer_desc=keep_declared)
def detection_output(ctx, ins, attrs):
    """reference: detection_output_op.h.  Loc [N, P * 4] decoded against
    PriorBox [2P, 4] (the priors, then their variances), Conf [N, P *
    num_classes] softmaxed; per image and class but the background, the
    priors scoring above `confidence_threshold` through `_nms` (its
    first `nms_top_k`); per image its `top_k` best.  Out [M, 7] rows
    (image, label, score, xmin, ymin, xmax, ymax) on the inputs' device,
    one row of -1 when nothing is kept.  On the host in the JAX op's
    numpy."""
    loc = _host(ins["Loc"][0])
    conf = _host(ins["Conf"][0])
    prior = _host(ins["PriorBox"][0]).reshape(-1, 4)
    num_classes = int(attrs["num_classes"])
    background = int(attrs.get("background_label_id", 0))
    nms_threshold = float(attrs.get("nms_threshold", 0.45))
    conf_threshold = float(attrs.get("confidence_threshold", 0.01))
    top_k = int(attrs.get("top_k", 100))
    nms_top_k = int(attrs.get("nms_top_k", 400))

    n_prior = prior.shape[0] // 2
    n = loc.shape[0]
    decoded = decode_boxes(loc.reshape(n, n_prior, 4), prior[:n_prior],
                           prior[n_prior:])
    conf = conf.reshape(n, n_prior, num_classes)
    e = np.exp(conf - conf.max(axis=-1, keepdims=True))
    conf = e / e.sum(axis=-1, keepdims=True)

    rows = []
    for b in range(n):
        dets = []
        for c in range(num_classes):
            if c == background:
                continue
            scores = conf[b, :, c]
            mask = scores > conf_threshold
            if not mask.any():
                continue
            idx = np.where(mask)[0]
            for k in _nms(decoded[b, idx], scores[idx], nms_threshold,
                          nms_top_k):
                i = idx[k]
                dets.append((float(scores[i]), c, decoded[b, i]))
        dets.sort(key=lambda d: -d[0])
        for score, c, box in dets[:top_k]:
            rows.append([float(b), float(c), score, float(box[0]),
                         float(box[1]), float(box[2]), float(box[3])])
    if not rows:
        rows = [[-1.0] * 7]
    return {"Out": [torch.from_numpy(np.asarray(rows, np.float32)).to(
        values_of(ins["Loc"][0]).device)]}


def _multibox_infer(ins, attrs):
    loc = ins["Loc"][0]
    return {"Loss": [torch.empty((loc.shape[0], 1), dtype=loc.dtype,
                                 device=loc.device)]}


@register_op("multibox_loss", nondiff_inputs=("PriorBox", "GtBox",
                                               "GtLabel"),
             infer_shape=_multibox_infer)
def multibox_loss(ctx, ins, attrs):
    """SSD's training loss (reference: MultiBoxLossLayer.cpp), the JAX
    op's fixed-shape computation.  Loc [N, P * 4], Conf [N, P * C],
    PriorBox [2P, 4], GtBox ragged [G, 4] and GtLabel ragged [G, 1] per
    image (rows past nvalid belong to no image).  A prior is positive
    when its best IoU with its image's gts reaches `overlap_threshold`
    (the first best gt), or when it is some gt's best prior (the first
    best; it then takes the best of the gts forcing it); a positive's
    smooth L1 against its gt's variance-encoded box and softmax cross
    entropy against its label, the `neg_pos_ratio` * positives
    negatives of largest cross entropy against the background (ranked
    by a stable argsort of a stable argsort), over the positives'
    count (at least 1).  Loss [N, 1]."""
    num_classes = int(attrs["num_classes"])
    overlap_threshold = float(attrs.get("overlap_threshold", 0.5))
    neg_pos_ratio = float(attrs.get("neg_pos_ratio", 3.0))
    background = int(attrs.get("background_label_id", 0))
    loc, conf = ins["Loc"][0], ins["Conf"][0]
    prior = ins["PriorBox"][0].reshape(-1, 4)
    gt_box_t, gt_label_t = ins["GtBox"][0], ins["GtLabel"][0]
    dev = loc.device

    n_prior = prior.shape[0] // 2
    pboxes, pvars = prior[:n_prior], prior[n_prior:]
    n = loc.shape[0]
    loc = loc.reshape(n, n_prior, 4)
    conf = conf.reshape(n, n_prior, num_classes)
    gt_boxes = values_of(gt_box_t)
    gt_labels = values_of(gt_label_t).reshape(-1).to(torch.int64)
    if gt_box_t is not gt_boxes:
        splits = gt_box_t.last_splits()
    else:
        splits = device_constant((0, gt_boxes.shape[0]), torch.int32,
                                 dev)
    g = gt_boxes.shape[0]
    img_of_gt = torch.searchsorted(
        splits[1:].contiguous(),
        torch.arange(g, dtype=splits.dtype, device=dev), right=True)

    iou = _iou(pboxes, gt_boxes)                               # [P, G]
    member = img_of_gt[None, :] == torch.arange(n, device=dev)[:, None,
                                                               None]
    neg_one = torch.full((), -1.0, dtype=iou.dtype, device=dev)
    iou_n = torch.where(member, iou[None], neg_one)            # [N, P, G]
    best_gt = torch.argmax(iou_n, dim=-1)                      # [N, P]
    best_iou = torch.gather(iou_n, -1, best_gt[..., None])[..., 0]
    positive = best_iou >= overlap_threshold

    valid_gt = member[:, 0, :]                                 # [N, G]
    best_prior = torch.argmax(iou_n, dim=1)                    # [N, G]
    hits = ((best_prior[..., None]
             == torch.arange(n_prior, device=dev))
            & valid_gt[..., None])                             # [N, G, P]
    forced = hits.any(dim=1)                                   # [N, P]
    forced_iou = torch.where(hits.transpose(1, 2), iou[None], neg_one)
    best_gt = torch.where(forced, torch.argmax(forced_iou, dim=-1),
                          best_gt)
    positive = positive | forced

    matched_box = gt_boxes[best_gt]                            # [N, P, 4]
    matched_label = gt_labels[best_gt]                         # [N, P]
    pw = pboxes[:, 2] - pboxes[:, 0]
    ph = pboxes[:, 3] - pboxes[:, 1]
    pcx = (pboxes[:, 0] + pboxes[:, 2]) / 2
    pcy = (pboxes[:, 1] + pboxes[:, 3]) / 2
    gw = torch.clamp(matched_box[..., 2] - matched_box[..., 0], min=1e-6)
    gh = torch.clamp(matched_box[..., 3] - matched_box[..., 1], min=1e-6)
    gcx = (matched_box[..., 0] + matched_box[..., 2]) / 2
    gcy = (matched_box[..., 1] + matched_box[..., 3]) / 2
    target = torch.stack(
        [(gcx - pcx) / pw / pvars[:, 0], (gcy - pcy) / ph / pvars[:, 1],
         torch.log(gw / pw) / pvars[:, 2], torch.log(gh / ph) / pvars[:, 3]],
        dim=-1)

    diff = torch.abs(loc - target)
    smooth_l1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    loc_loss = (smooth_l1.sum(-1) * positive).sum(-1)          # [N]

    logp = torch.log_softmax(conf, dim=-1)
    cls = torch.where(positive, matched_label,
                      torch.full((), background, dtype=torch.int64,
                                 device=dev))
    ce = -torch.gather(logp, -1, cls[..., None])[..., 0]       # [N, P]

    npos = positive.sum(-1)                                    # [N]
    neg_ce = torch.where(positive, torch.full((), float("-inf"),
                                              dtype=ce.dtype, device=dev),
                         ce).detach()
    order = torch.argsort(-neg_ce, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    n_neg = torch.minimum(neg_pos_ratio * npos, n_prior - npos)
    negative = (~positive) & (rank < n_neg[:, None])
    conf_loss = (ce * (positive | negative)).sum(-1)           # [N]

    denom = torch.clamp(npos.to(loc.dtype), min=1.0)
    return {"Loss": [((loc_loss + conf_loss) / denom)[:, None]]}


def _unpack(t):
    """(valid rows, splits) of a ragged value, or (all rows, [0, rows])
    of a dense one, on the host."""
    if t is not values_of(t):
        return _host(t)[:int(t.nvalid)], t.last_splits().cpu().numpy()
    v = _host(t)
    return v, np.asarray([0, v.shape[0]], np.int64)


@register_op("detection_map", jittable=False, stop_gradient_op=True,
             nondiff_inputs=("DetectRes", "Label"),
             infer_desc=keep_declared)
def detection_map(ctx, ins, attrs):
    """Mean average precision (reference: DetectionMAPEvaluator.cpp),
    the JAX op's host loop.  DetectRes: ragged rows (label, score, xmin,
    ymin, xmax, ymax), one sequence per image; Label: ragged rows
    (label, xmin, ymin, xmax, ymax[, difficult]).  Per class, detections
    by descending score each take the best-IoU gt of their image; a hit
    at `overlap_threshold` on an unmatched gt is a true positive, on a
    matched one a false positive, on a difficult one neither (unless
    `evaluate_difficult`).  AP is 11-point or integral; MAP [1] the mean
    over classes with a gt."""
    overlap_threshold = float(attrs.get("overlap_threshold", 0.5))
    background = int(attrs.get("background_label_id", 0))
    ap_type = attrs.get("ap_type", "11point")
    evaluate_difficult = bool(attrs.get("evaluate_difficult", False))
    det, det_splits = _unpack(ins["DetectRes"][0])
    gt, gt_splits = _unpack(ins["Label"][0])
    has_difficult = gt.shape[1] >= 6

    by_class_det, by_class_gt = {}, {}
    for i in range(len(det_splits) - 1):
        for r in det[det_splits[i]:det_splits[i + 1]]:
            c = int(r[0])
            if c != background:
                by_class_det.setdefault(c, []).append((i, float(r[1]),
                                                       r[2:6]))
        for r in gt[gt_splits[i]:gt_splits[i + 1]]:
            c = int(r[0])
            hard = bool(r[5]) if has_difficult else False
            if c != background:
                by_class_gt.setdefault(c, []).append((i, r[1:5], hard))

    aps = []
    for c, gts in by_class_gt.items():
        npos = sum(1 for _, _, hard in gts
                   if evaluate_difficult or not hard)
        dets = sorted(by_class_det.get(c, []), key=lambda d: -d[1])
        iou_mat = None
        if dets:
            iou_mat = _iou_np(np.stack([d[2] for d in dets]),
                              np.stack([g[1] for g in gts]))
        gt_imgs = np.asarray([g[0] for g in gts])
        matched = set()
        tps, fps = [], []
        for di, (img, _score, _box) in enumerate(dets):
            cand = np.where(gt_imgs == img)[0]
            if cand.size == 0:
                tps.append(0.0)
                fps.append(1.0)
                continue
            ious = iou_mat[di, cand]
            k = int(np.argmax(ious))
            best_j, best_iou = int(cand[k]), float(ious[k])
            if best_iou >= overlap_threshold:
                if gts[best_j][2] and not evaluate_difficult:
                    tps.append(0.0)
                    fps.append(0.0)
                elif best_j not in matched:
                    matched.add(best_j)
                    tps.append(1.0)
                    fps.append(0.0)
                else:
                    tps.append(0.0)
                    fps.append(1.0)
            else:
                tps.append(0.0)
                fps.append(1.0)
        if npos == 0:
            continue
        tp_cum, fp_cum = np.cumsum(tps), np.cumsum(fps)
        recall = tp_cum / npos
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        ap = 0.0
        if ap_type == "11point":
            for thr in np.linspace(0, 1, 11):
                mask = recall >= thr
                ap += (precision[mask].max() if mask.any() else 0.0) / 11
        else:
            prev_r = 0.0
            for p, r in zip(precision, recall):
                ap += p * (r - prev_r)
                prev_r = r
        aps.append(ap)
    m = float(np.mean(aps)) if aps else 0.0
    return {"MAP": [torch.tensor([m], dtype=torch.float32,
                                 device=values_of(ins["Label"][0]).device)]}
