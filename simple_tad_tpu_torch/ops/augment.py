"""Batched on-device training augmentation for frame fine-tuning, in
PyTorch.

Port of the fine-tuning path of simple_tad_tpu/ops/augment.py
(``train_augment``; reference: _aug_frame, dota.py:288-331):
  1. ``pad_wide_and_resize``: random vertical pad {none x5, black x2,
     color x1, reflect-blend x2, replicate x2} with U(0, 0.5 (w - h))
     top/bottom offsets, then cubic resize to crop^2 (Keys a = -0.5);
  2. ``rand_augment_drive``: 'rand-m6-n3-mstd0.5-inc1' over the 10
     driving-safe ops, clip-consistent parameters;
  3. /255 and ImageNet normalization;
  4. ``random_erasing``: p = 0.25, pixel-mode noise, one cube per clip.

Every random op is split into ``draw_*`` (its parameters, from an explicit
``torch.Generator`` on the video's device) and ``apply_*`` (the op on
those parameters), so tests can feed both packages the same parameters.
The whole batch is processed at once on its device: per-sample parameters
are tensors, and the RandAugment ops run once per (layer, op) on the
samples that drew that op.  Video is float (B, T, H, W, C) in [0, 255]
(channels-last, as in the JAX package).

The pre-training (MAE / DAPT) pipelines (the JAX package's
pretrain_augment_orig and pretrain_augment_align) follow the same split:
``group_multi_scale_crop`` (TSN's GroupMultiScaleCrop: a (w, h) crop pair
of the scaled base size, one of 13 fixed offsets, bilinear resize,
clip-consistent per sample), and ``pretrain_augment_align``'s
pad + resize, RandAugment on the clips whose gate draw exceeds 0.3
(dota.py:706) and a light crop.

Action-recognition class fine-tuning (the JAX CLI's train_augment_cls,
kinetics.py _aug_frame + mixup.py): ``random_resized_crop``
(torchvision's RandomResizedCrop, clip-consistent), ``random_hflip``,
``rand_augment_full`` ('rand-m7-n4-mstd0.5-inc1': the 10 drive ops plus
posterize, solarize and the two translations), ``random_erasing`` and
``mixup_cutmix`` (one lambda per batch, each sample mixed with its
batch-flipped partner, label-smoothed soft targets), in
``train_augment_cls``.  Their draws stay on the device: the full
RandAugment evaluates each op on the whole batch and keeps it where a
sample drew it, so no draw is read on the host.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from simple_tad_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD

GRAY_FILL = 128.0
NUM_RA_OPS = 10   # autocontrast equalize invert rotate color contrast
                  # brightness sharpness shear_x shear_y
PAD_MODES = ("none", "black", "color", "reflect", "replicate")


def _uniform(shape, generator, device):
    return torch.rand(shape, generator=generator, device=device)


_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def _const(values, device, dtype=torch.float32) -> torch.Tensor:
    """A constant tensor of ``values`` (nested tuples of numbers) on
    ``device``, made once: a tensor built from host values on each call is
    a copy from pageable memory, which waits for the device's stream."""
    key = (values, str(device), dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype,
                                           device=device)
    return t


# ---------------------------------------------------------------- sampling --

def _cubic_weights(t):
    """Keys cubic (a = -0.5) weights for fractional offset t: taps -1..2."""
    a = -0.5
    t2, t3 = t * t, t * t * t
    w0 = a * (t3 - 2 * t2 + t)
    w1 = (a + 2) * t3 - (a + 3) * t2 + 1
    w2 = -(a + 2) * t3 + (2 * a + 3) * t2 - a * t
    w3 = -a * (t3 - t2)
    return w0, w1, w2, w3


def _resample_rows_cubic(video, coords, mode: str, fill):
    """4-tap cubic resample of video (b, T, H, W, C) along H at per-sample
    float row coordinates ``coords`` (b, H').  mode: 'constant'
    (out-of-range taps read ``fill``, (b, C) or a scalar), 'replicate'
    (clamp), 'reflect' (edge pixel duplicated, period 2n)."""
    b, T, n, W, C = video.shape
    base = torch.floor(coords)
    w = _cubic_weights(coords - base)
    base = base.long()
    bidx = torch.arange(b, device=video.device)[:, None]
    out = None
    for wk, off in zip(w, (-1, 0, 1, 2)):
        idx = base + off
        if mode == "reflect":
            idx = (idx + (idx < 0).long()).abs()
            idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
        rows = video[bidx, :, idx.clamp(0, n - 1)]        # (b, H', T, W, C)
        rows = rows.permute(0, 2, 1, 3, 4)
        if mode == "constant":
            inr = ((idx >= 0) & (idx < n))[:, None, :, None, None]
            fill_t = torch.as_tensor(fill, dtype=video.dtype,
                                     device=video.device)
            if fill_t.ndim:
                fill_t = fill_t[:, None, None, None, :]
            rows = torch.where(inr, rows, fill_t)
        term = wk[:, None, :, None, None] * rows
        out = term if out is None else out + term
    return out


def _resample_cols_cubic(video, coords):
    """4-tap cubic resample along W (axis 3) at coordinates (W',) shared by
    the batch, edge-clamped."""
    n = video.shape[3]
    base = torch.floor(coords)
    w = _cubic_weights(coords - base)
    base = base.long()
    out = None
    for wk, off in zip(w, (-1, 0, 1, 2)):
        term = wk[:, None] * video.index_select(3, (base + off).clamp(0, n - 1))
        out = term if out is None else out + term
    return out


# ------------------------------------------------------ pad_wide + resize --

def draw_pad_wide(video, generator) -> Dict[str, torch.Tensor]:
    """Per-sample pad parameters: mode (index into PAD_MODES; 12 slots:
    0-4 none, 5-6 black, 7 color, 8-9 reflect, 10-11 replicate), pad_top,
    pad_bot (rounded U(0, 0.5 (W - H))), alpha (U(0, 0.7), the reflect
    blend) and color (B, 3) in 0..255."""
    B, _, H, W, _ = video.shape
    dev = video.device
    slot = torch.randint(0, 12, (B,), generator=generator, device=dev)
    mode = torch.bucketize(slot, _const((5, 7, 8, 10), dev, torch.long),
                           right=True)
    h_to_sq = max(W - H, 0)
    return {
        "mode": mode,
        "pad_top": torch.round(_uniform(B, generator, dev) * 0.5 * h_to_sq),
        "pad_bot": torch.round(_uniform(B, generator, dev) * 0.5 * h_to_sq),
        "alpha": _uniform(B, generator, dev) * 0.7,
        "color": torch.randint(0, 256, (B, 3), generator=generator,
                               device=dev).float(),
    }


def apply_pad_wide(video, params, crop_size: int):
    """Random vertical pad-to-square + cubic resize: (B, T, H, W, C) float
    [0, 255] with W >= H -> (B, T, crop, crop, C), clipped to [0, 255]."""
    B, T, H, W, C = video.shape
    dev = video.device
    ys = torch.arange(crop_size, dtype=torch.float32, device=dev)
    xs = (ys + 0.5) * (W / crop_size) - 0.5
    rows = torch.empty((B, T, crop_size, W, C), dtype=video.dtype,
                       device=dev)
    for m, name in enumerate(PAD_MODES):
        sel = torch.nonzero(params["mode"] == m)[:, 0]
        if sel.numel() == 0:
            continue
        clip = video[sel]
        if name == "none":
            y = ((ys + 0.5) * (H / crop_size) - 0.5).expand(len(sel), -1)
            rows[sel] = _resample_rows_cubic(clip, y, "replicate", 0.0)
            continue
        pt = params["pad_top"][sel][:, None]
        hp = H + pt + params["pad_bot"][sel][:, None]
        y = (ys + 0.5) * (hp / crop_size) - 0.5 - pt
        if name == "black":
            out = _resample_rows_cubic(clip, y, "constant", 0.0)
        elif name == "color":
            out = _resample_rows_cubic(clip, y, "constant",
                                       params["color"][sel])
        elif name == "reflect":
            a = params["alpha"][sel][:, None, None, None, None]
            out = (_resample_rows_cubic(clip, y, "reflect", 0.0) * a
                   + _resample_rows_cubic(clip, y, "constant", 0.0) * (1 - a))
        else:
            out = _resample_rows_cubic(clip, y, "replicate", 0.0)
        rows[sel] = out
    return torch.clamp(_resample_cols_cubic(rows, xs), 0.0, 255.0)


def pad_wide_and_resize(video, generator, crop_size: int):
    return apply_pad_wide(video, draw_pad_wide(video, generator), crop_size)


# ------------------------------------------------------- randaugment ops --
# Each op maps clips (b, T, H, W, C) and per-sample magnitude (b,) and sign
# (b,) bool -> (b, T, H, W, C).

def _bcast(v):
    return v[:, None, None, None, None]


def _luma(x):
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]


def _blend(a, b, factor):
    """PIL Image.blend semantics used by enhancers: b + factor * (a - b)."""
    return b + factor * (a - b)


def _enhance_factor(mag, sign):
    """timm increasing variant: 1 +/- 0.9 * mag / 10."""
    s = torch.where(sign, 1.0, -1.0)
    return _bcast(1.0 + s * 0.9 * mag / 10.0)


def op_autocontrast(x, mag, sign):
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1e-6)
    return torch.where(hi > lo, (x - lo) * scale, x)


def op_equalize(x, mag, sign):
    """PIL ImageOps.equalize per channel, LUT over the whole clip."""
    b, C = x.shape[0], x.shape[-1]
    vals = torch.clamp(x, 0, 255).long()
    base = ((torch.arange(b, device=x.device)[:, None] * C
             + torch.arange(C, device=x.device)[None, :]) * 256)
    flat = vals + base[:, None, None, None, :]
    # a scatter, not torch.bincount, whose CUDA version reads the largest
    # value on the host
    h = torch.zeros(b * C * 256, dtype=torch.long, device=x.device)
    h.scatter_add_(0, flat.reshape(-1), torch.ones_like(flat.reshape(-1)))
    h = h.view(b, C, 256)
    step = (h.sum(-1) - h[..., 255]) // 255                     # (b, C)
    csum = torch.cumsum(h, -1) - h
    lut = torch.clamp((step[..., None] // 2 + csum)
                      // torch.clamp(step, min=1)[..., None], 0, 255)
    out = lut.reshape(-1)[flat].to(x.dtype)
    return torch.where((step == 0)[:, None, None, None, :], x, out)


def op_invert(x, mag, sign):
    return 255.0 - x


def op_color(x, mag, sign):
    return _blend(x, _luma(x).expand_as(x), _enhance_factor(mag, sign))


def op_contrast(x, mag, sign):
    mean = _luma(x).mean(dim=(2, 3), keepdim=True)             # per frame
    return _blend(x, mean.expand_as(x), _enhance_factor(mag, sign))


def op_brightness(x, mag, sign):
    return x * _enhance_factor(mag, sign)


def _smooth(x):
    """PIL SMOOTH (3x3 [[1,1,1],[1,5,1],[1,1,1]] / 13, zero padding) per
    frame and channel, the 1-pixel border left unfiltered."""
    H, W = x.shape[2], x.shape[3]
    p = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            wgt = (5.0 if dy == dx == 1 else 1.0) / 13.0
            term = wgt * p[:, :, dy:dy + H, dx:dx + W]
            acc = term if acc is None else acc + term
    border = torch.zeros((H, W), dtype=torch.bool, device=x.device)
    border[0], border[-1], border[:, 0], border[:, -1] = True, True, True, True
    return torch.where(border[None, None, :, :, None], x, acc)


def op_sharpness(x, mag, sign):
    return _blend(x, _smooth(x), _enhance_factor(mag, sign))


def _warp(x, coeffs):
    """PIL AFFINE inverse-map warp with per-sample coefficients (a..f, each
    (b,)): out(x, y) <- src(a x + b y + c, d x + e y + f), bilinear, gray
    fill outside."""
    b, T, H, W, C = x.shape
    a, bb, c, d, e, f = (t[:, None, None] for t in coeffs)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                         device=x.device),
                            torch.arange(W, dtype=torch.float32,
                                         device=x.device), indexing="ij")
    sx = a * xs + bb * ys + c
    sy = d * xs + e * ys + f
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[:, None, :, :, None]
    wy = (sy - y0)[:, None, :, :, None]
    x0i = x0.long().clamp(0, W - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    y0i = y0.long().clamp(0, H - 1)
    y1i = (y0i + 1).clamp(0, H - 1)
    bidx = torch.arange(b, device=x.device)[:, None, None]

    def at(yi, xi):
        return x[bidx, :, yi, xi].permute(0, 3, 1, 2, 4)

    top = at(y0i, x0i) * (1 - wx) + at(y0i, x1i) * wx
    bot = at(y1i, x0i) * (1 - wx) + at(y1i, x1i) * wx
    out = top * (1 - wy) + bot * wy
    valid = ((sx >= -0.5) & (sx <= W - 0.5) & (sy >= -0.5)
             & (sy <= H - 0.5))[:, None, :, :, None]
    return torch.where(valid, out, GRAY_FILL)


def op_rotate(x, mag, sign):
    deg = mag / 10.0 * 30.0
    rad = torch.deg2rad(torch.where(sign, deg, -deg))
    h, w = x.shape[2], x.shape[3]
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos, sin = torch.cos(rad), torch.sin(rad)
    a, b = cos, sin
    d, e = -sin, cos
    return _warp(x, (a, b, cx - a * cx - b * cy, d, e, cy - d * cx - e * cy))


def op_shear_x(x, mag, sign):
    s = mag / 10.0 * 0.3
    s = torch.where(sign, s, -s)
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    return _warp(x, (one, s, zero, zero, one, zero))


def op_shear_y(x, mag, sign):
    s = mag / 10.0 * 0.3
    s = torch.where(sign, s, -s)
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    return _warp(x, (one, zero, zero, s, one, zero))


RA_OPS = (op_autocontrast, op_equalize, op_invert, op_rotate, op_color,
          op_contrast, op_brightness, op_sharpness, op_shear_x, op_shear_y)


def draw_rand_augment(video, generator, *, magnitude: float = 6.0,
                      mstd: float = 0.5, num_layers: int = 3,
                      prob: float = 0.5, n_ops: int = NUM_RA_OPS
                      ) -> Dict[str, torch.Tensor]:
    """Per sample and layer (B, num_layers): op index (uniform over the
    ``n_ops`` ops, with replacement), magnitude ~ N(magnitude, mstd)
    clipped to [0, 10], apply (probability ``prob``) and the op's random
    sign."""
    B = video.shape[0]
    dev = video.device
    shape = (B, num_layers)
    return {
        "op": torch.randint(0, n_ops, shape, generator=generator,
                            device=dev),
        "mag": torch.clamp(magnitude + mstd * torch.randn(
            shape, generator=generator, device=dev), 0.0, 10.0),
        "apply": _uniform(shape, generator, dev) < prob,
        "sign": _uniform(shape, generator, dev) < 0.5,
    }


def apply_rand_augment(video, params):
    """Apply each layer's drawn op to each sample (clipped to [0, 255]),
    keeping the sample unchanged where ``apply`` is False."""
    x = video
    ops = params["op"].cpu()
    for layer in range(ops.shape[1]):
        x = x.clone()
        for op in torch.unique(ops[:, layer]).tolist():
            sel = torch.nonzero(ops[:, layer] == op)[:, 0].to(x.device)
            clip = x[sel]
            out = torch.clamp(RA_OPS[op](clip, params["mag"][sel, layer],
                                         params["sign"][sel, layer]),
                              0.0, 255.0)
            x[sel] = torch.where(_bcast(params["apply"][sel, layer]), out,
                                 clip)
    return x


def rand_augment_drive(video, generator, **kw):
    return apply_rand_augment(video, draw_rand_augment(video, generator,
                                                       **kw))


# -------------------------------------------------------- random erasing --

def draw_random_erasing(video, generator, *, probability: float = 0.25,
                        min_area: float = 0.02, max_area: float = 1 / 3,
                        min_aspect: float = 0.01) -> Dict[str, torch.Tensor]:
    """Per sample: one rectangle (h, w, top, left), whether to erase it,
    and standard-normal noise of the video's shape."""
    B, T, H, W, C = video.shape
    dev = video.device
    area = (min_area + _uniform(B, generator, dev) * (max_area - min_area)) \
        * (H * W)
    lo, hi = math.log(min_aspect), math.log(1.0 / min_aspect)
    ar = torch.exp(lo + _uniform(B, generator, dev) * (hi - lo))
    h = torch.clamp(torch.round(torch.sqrt(area * ar)), 1, H - 1).long()
    w = torch.clamp(torch.round(torch.sqrt(area / ar)), 1, W - 1).long()
    return {
        "h": h, "w": w,
        "top": (_uniform(B, generator, dev) * (H - h)).long(),
        "left": (_uniform(B, generator, dev) * (W - w)).long(),
        "erase": _uniform(B, generator, dev) < probability,
        "noise": torch.randn(video.shape, generator=generator, device=dev,
                             dtype=video.dtype),
    }


def apply_random_erasing(video, params):
    """Pixel-mode cube RandomErasing (random_erasing.py:27-173, mode
    'pixel', cube, count 1): the rectangle, the same in every frame, gets
    the noise."""
    H, W = video.shape[2], video.shape[3]
    ys = torch.arange(H, device=video.device)[None, :]
    xs = torch.arange(W, device=video.device)[None, :]
    top, left = params["top"][:, None], params["left"][:, None]
    row = (ys >= top) & (ys < top + params["h"][:, None])          # (B, H)
    col = (xs >= left) & (xs < left + params["w"][:, None])        # (B, W)
    mask = (row[:, None, :, None, None] & col[:, None, None, :, None]
            & _bcast(params["erase"]))
    return torch.where(mask, params["noise"], video)


def random_erasing(video, generator, **kw):
    return apply_random_erasing(video, draw_random_erasing(video, generator,
                                                           **kw))


# --------------------------------------------------------------- pipeline --

def normalize(x):
    """[0, 255] -> ImageNet-normalized, as the JAX train pipeline does it."""
    mean = _const(tuple(map(float, IMAGENET_MEAN)), x.device)
    std = _const(tuple(map(float, IMAGENET_STD)), x.device)
    return (x / 255.0 - mean) / std


def train_augment(video_u8, generator, *, crop_size: int = 224,
                  magnitude: float = 6.0, num_layers: int = 3,
                  reprob: float = 0.25, dtype=torch.float32):
    """The full train-path augmentation: (B, T, H, W, C) uint8 frames on
    the device -> normalized, augmented (B, T, crop, crop, C) in ``dtype``.
    Order as _aug_frame (dota.py:288-331): pad + resize -> RandAugment ->
    /255 + ImageNet normalize -> RandomErasing."""
    x = video_u8.float()
    x = pad_wide_and_resize(x, generator, crop_size)
    x = rand_augment_drive(x, generator, magnitude=magnitude,
                           num_layers=num_layers)
    x = normalize(x)
    if reprob > 0:
        x = random_erasing(x, generator, probability=reprob)
    return x.to(dtype)


# --------------------------------------------- pre-training (MAE / DAPT) --

ORIG_SCALES = (1.0, 0.875, 0.75, 0.66)
ALIGN_SCALES = (1, 1, 0.975, 0.95, 0.9, 0.875, 0.85)
# the 13 fixed offsets of GroupMultiScaleCrop (transforms.py:139-165), as
# multiples of a quarter of the slack, (w, h)
CROP_OFFSETS = ((0, 0), (4, 0), (0, 4), (4, 4), (2, 2), (0, 2), (4, 2),
                (2, 4), (2, 0), (1, 1), (3, 1), (1, 3), (3, 3))


def crop_pairs(H: int, W: int, out_size: int, scales=ORIG_SCALES,
               max_distort: int = 1):
    """The (w, h) crop sizes GroupMultiScaleCrop chooses among: the base
    size min(H, W) times each scale (snapped to out_size within 3 pixels),
    pairs whose scale indices differ by at most ``max_distort``."""
    sizes = [int(min(H, W) * s) for s in scales]
    sizes = [out_size if abs(s - out_size) < 3 else s for s in sizes]
    return [(w, h) for i, h in enumerate(sizes)
            for j, w in enumerate(sizes) if abs(i - j) <= max_distort]


def draw_multi_scale_crop(video, generator, scales=ORIG_SCALES,
                          max_distort: int = 1) -> Dict[str, torch.Tensor]:
    """Per sample: the index of its (w, h) crop pair (uniform) and of its
    offset (uniform over the 13).  The pair count depends on the scales
    alone, not on the video's size."""
    B = video.shape[0]
    n = len(scales)
    n_pairs = sum(abs(i - j) <= max_distort for i in range(n)
                  for j in range(n))
    dev = video.device
    return {"pair": torch.randint(0, n_pairs, (B,), generator=generator,
                                  device=dev),
            "offset": torch.randint(0, len(CROP_OFFSETS), (B,),
                                    generator=generator, device=dev)}


def apply_multi_scale_crop(video, params, out_size: int, scales=ORIG_SCALES,
                           max_distort: int = 1):
    """Crop each clip at its drawn size and offset and resize it to
    out_size x out_size by bilinear sampling at pixel centres (PIL's crop
    then resize, without its antialiasing): (B, T, H, W, C) float ->
    (B, T, out, out, C); samples outside the clip read 0."""
    B, T, H, W, C = video.shape
    dev = video.device
    pairs = _const(tuple(crop_pairs(H, W, out_size, scales, max_distort)),
                   dev)
    mult = _const(CROP_OFFSETS, dev)
    crop_w, crop_h = pairs[params["pair"]].unbind(1)
    off_w = mult[params["offset"], 0] * torch.floor((W - crop_w) / 4.0)
    off_h = mult[params["offset"], 1] * torch.floor((H - crop_h) / 4.0)
    return _crop_resize(video, crop_w, crop_h, off_w, off_h, out_size)


def _crop_resize(video, crop_w, crop_h, off_w, off_h, out_size: int):
    """Each clip's (crop_w x crop_h) crop at (off_w, off_h) (per-sample
    (B,) floats) resized to out_size x out_size by bilinear sampling at
    pixel centres (PIL's crop then resize, without its antialiasing);
    samples outside the clip read 0."""
    B, T, H, W, C = video.shape
    dev = video.device
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    sx = off_w[:, None] + (o + 0.5) * (crop_w / out_size)[:, None] - 0.5
    sy = off_h[:, None] + (o + 0.5) * (crop_h / out_size)[:, None] - 0.5
    sx = sx[:, None, :].expand(B, out_size, out_size)      # (B, y, x)
    sy = sy[:, :, None].expand(B, out_size, out_size)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx = (sx - x0)[:, None, :, :, None]
    wy = (sy - y0)[:, None, :, :, None]
    x0i = x0.long().clamp(0, W - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    y0i = y0.long().clamp(0, H - 1)
    y1i = (y0i + 1).clamp(0, H - 1)
    bidx = torch.arange(B, device=dev)[:, None, None]

    def at(yi, xi):
        return video[bidx, :, yi, xi].permute(0, 3, 1, 2, 4)

    top = at(y0i, x0i) * (1 - wx) + at(y0i, x1i) * wx
    bot = at(y1i, x0i) * (1 - wx) + at(y1i, x1i) * wx
    out = top * (1 - wy) + bot * wy
    valid = ((sx >= -0.5) & (sx <= W - 0.5) & (sy >= -0.5)
             & (sy <= H - 0.5))[:, None, :, :, None]
    return torch.where(valid, out, torch.zeros((), device=dev))


def group_multi_scale_crop(video, generator, out_size: int,
                           scales=ORIG_SCALES, max_distort: int = 1):
    return apply_multi_scale_crop(
        video, draw_multi_scale_crop(video, generator, scales, max_distort),
        out_size, scales, max_distort)


def draw_pretrain_orig(video_u8, generator) -> Dict[str, torch.Tensor]:
    """The draws of ``pretrain_augment_orig``: its crop."""
    return {"crop": draw_multi_scale_crop(video_u8, generator)}


def apply_pretrain_orig(video_u8, params, *, crop_size: int = 224,
                        dtype=torch.float32):
    """MAE's 'orig' pipeline (datasets_frame.py:13-39): GroupMultiScaleCrop
    [1, .875, .75, .66] -> /255 -> ImageNet normalize, in ``dtype``."""
    x = apply_multi_scale_crop(video_u8.float(), params["crop"], crop_size)
    return normalize(x).to(dtype)


def pretrain_augment_orig(video_u8, generator, *, crop_size: int = 224,
                          dtype=torch.float32):
    return apply_pretrain_orig(video_u8, draw_pretrain_orig(video_u8,
                                                            generator),
                               crop_size=crop_size, dtype=dtype)


def draw_pretrain_align(video_u8, generator, *, magnitude: float = 6.0,
                        num_layers: int = 3
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The draws of ``pretrain_augment_align``: the pad, the RandAugment
    layers, the per-clip gate (U(0, 1)) and the crop of the padded
    clips."""
    return {"pad": draw_pad_wide(video_u8, generator),
            "ra": draw_rand_augment(video_u8, generator, magnitude=magnitude,
                                    num_layers=num_layers),
            "gate": _uniform(video_u8.shape[0], generator, video_u8.device),
            "crop": draw_multi_scale_crop(video_u8, generator, ALIGN_SCALES)}


def apply_pretrain_align(video_u8, params, *, crop_size: int = 224,
                         dtype=torch.float32):
    """DAPT's 'transforms_finetune_align' pipeline (dota.py:697-716 with
    DataAugmentationForVideoMAE_LightCrop): pad + resize -> the drive
    RandAugment on the clips whose gate exceeds 0.3 -> the light
    GroupMultiScaleCrop -> /255 -> ImageNet normalize, in ``dtype``."""
    x = apply_pad_wide(video_u8.float(), params["pad"], crop_size)
    aug = apply_rand_augment(x, params["ra"])
    x = torch.where(_bcast(params["gate"] > 0.3), aug, x)
    x = apply_multi_scale_crop(x, params["crop"], crop_size, ALIGN_SCALES)
    return normalize(x).to(dtype)


def pretrain_augment_align(video_u8, generator, *, crop_size: int = 224,
                           magnitude: float = 6.0, num_layers: int = 3,
                           dtype=torch.float32):
    return apply_pretrain_align(
        video_u8, draw_pretrain_align(video_u8, generator,
                                      magnitude=magnitude,
                                      num_layers=num_layers),
        crop_size=crop_size, dtype=dtype)


# ------------------------------- action-recognition class fine-tuning --

def op_posterize(x, mag, sign):
    """Keep 4 - int(mag / 10 * 4) high bits: PosterizeIncreasing's range
    [4..0] (rand_augment.py:247-252)."""
    bits = torch.clamp(4.0 - torch.floor(mag / 10.0 * 4.0), 0, 4)
    shift = _bcast((8 - bits).long())
    vals = torch.clamp(x, 0, 255).long()
    return ((vals >> shift) << shift).to(x.dtype)


def op_solarize(x, mag, sign):
    """Invert the pixels at or above 256 - mag / 10 * 256 (timm's
    increasing variant)."""
    thresh = _bcast(256.0 - mag / 10.0 * 256.0)
    return torch.where(x >= thresh, 255.0 - x, x)


def _translate_shift(mag, sign, extent: int):
    frac = mag / 10.0 * 0.45
    return torch.where(sign, frac, -frac) * extent


def op_translate_x(x, mag, sign):
    s = _translate_shift(mag, sign, x.shape[3])
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    return _warp(x, (one, zero, s, zero, one, zero))


def op_translate_y(x, mag, sign):
    s = _translate_shift(mag, sign, x.shape[2])
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    return _warp(x, (one, zero, zero, zero, one, s))


RA_FULL_OPS = RA_OPS + (op_posterize, op_solarize, op_translate_x,
                        op_translate_y)


def draw_rand_augment_full(video, generator, *, magnitude: float = 7.0,
                           mstd: float = 0.5, num_layers: int = 4,
                           prob: float = 0.5) -> Dict[str, torch.Tensor]:
    """``draw_rand_augment`` over the 14 ops of RA_FULL_OPS, at the class
    fine-tuning defaults (m7, n4)."""
    return draw_rand_augment(video, generator, magnitude=magnitude,
                             mstd=mstd, num_layers=num_layers, prob=prob,
                             n_ops=len(RA_FULL_OPS))


def apply_rand_augment_full(video, params):
    """Each layer: every op of RA_FULL_OPS on the whole batch (clipped to
    [0, 255]), kept where a sample drew it and its ``apply`` holds.  No
    draw is read on the host, at the price of running all 14 ops."""
    x = video
    for layer in range(params["op"].shape[1]):
        op, use = params["op"][:, layer], params["apply"][:, layer]
        mag, sign = params["mag"][:, layer], params["sign"][:, layer]
        out = x
        for k, fn in enumerate(RA_FULL_OPS):
            y = torch.clamp(fn(x, mag, sign), 0.0, 255.0)
            out = torch.where(_bcast(use & (op == k)), y, out)
        x = out
    return x


def rand_augment_full(video, generator, **kw):
    return apply_rand_augment_full(video, draw_rand_augment_full(
        video, generator, **kw))


def draw_random_resized_crop(video, generator, scale=(0.08, 1.0),
                             ratio=(3 / 4, 4 / 3)) -> Dict[str, torch.Tensor]:
    """Per sample: the crop's area as a share of the clip's (U(scale)), its
    log aspect ratio (U(log ratio)) and the U(0, 1) draws that place it."""
    B, dev = video.shape[0], video.device
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    return {"area": scale[0] + _uniform(B, generator, dev)
            * (scale[1] - scale[0]),
            "log_ratio": lo + _uniform(B, generator, dev) * (hi - lo),
            "x": _uniform(B, generator, dev),
            "y": _uniform(B, generator, dev)}


def apply_random_resized_crop(video, params, out_size: int):
    """torchvision's RandomResizedCrop, clip-consistent per sample
    (video_transforms.random_resized_crop, kinetics.py _aug_frame): the
    drawn area and aspect ratio, each side clipped to [8, the clip's], the
    crop placed at the drawn share of the slack, bilinear resize."""
    B, T, H, W, C = video.shape
    target = params["area"] * (H * W)
    r = torch.exp(params["log_ratio"])
    w = torch.clamp(torch.sqrt(target * r), 8, W)
    h = torch.clamp(torch.sqrt(target / r), 8, H)
    return _crop_resize(video, w, h, params["x"] * (W - w),
                        params["y"] * (H - h), out_size)


def random_resized_crop(video, generator, out_size: int, **kw):
    return apply_random_resized_crop(
        video, draw_random_resized_crop(video, generator, **kw), out_size)


def draw_random_hflip(video, generator, prob: float = 0.5
                      ) -> Dict[str, torch.Tensor]:
    return {"flip": _uniform(video.shape[0], generator, video.device) < prob}


def apply_random_hflip(video, params):
    """Per-sample horizontal flip, clip-consistent."""
    return torch.where(_bcast(params["flip"]), video.flip(3), video)


def random_hflip(video, generator, prob: float = 0.5):
    return apply_random_hflip(video, draw_random_hflip(video, generator,
                                                       prob))


def _beta(alpha: float, generator, device):
    """One Beta(alpha, alpha) draw, a 0-dim tensor on ``device``; 1 where
    alpha is 0 (that mode is off)."""
    if alpha <= 0:
        return torch.ones((), device=device)
    conc = torch.full((2,), float(alpha), device=device)
    return torch._sample_dirichlet(conc, generator=generator)[0]


def draw_mixup_cutmix(video, generator, *, mixup_alpha: float = 0.8,
                      cutmix_alpha: float = 1.0, switch_prob: float = 0.5,
                      prob: float = 1.0) -> Dict[str, torch.Tensor]:
    """One draw per batch (timm Mixup's batch mode), each a 0-dim tensor
    on the video's device: whether to mix, whether by cutmix, the two
    lambdas (Beta(alpha, alpha)) and the cutmix box's centre."""
    H, W, dev = video.shape[2], video.shape[3], video.device
    return {"use": _uniform((), generator, dev) < prob,
            "use_cutmix": _uniform((), generator, dev) < switch_prob,
            "lam_mix": _beta(mixup_alpha, generator, dev),
            "lam_cut": _beta(cutmix_alpha, generator, dev),
            "cy": torch.randint(0, H, (), generator=generator, device=dev),
            "cx": torch.randint(0, W, (), generator=generator, device=dev)}


def apply_mixup_cutmix(video, labels, params, *, num_classes: int,
                       label_smoothing: float = 0.1):
    """Batch mixup / cutmix with soft targets (mixup.py:100-316): each
    sample mixed with its batch-flipped partner, by a blend at lam_mix or
    by pasting the partner's box (timm rand_bbox: area share 1 - lam_cut
    around the drawn centre, clipped, lam the share left) -> (video,
    (B, num_classes) fp32 label-smoothed targets mixed at the same lam)."""
    H, W = video.shape[2], video.shape[3]
    onehot = F.one_hot(labels.long(), num_classes).float()
    onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    flipped = video.flip(0)
    lam_mix = params["lam_mix"]
    blend = video * lam_mix + flipped * (1.0 - lam_mix)
    cut_rat = torch.sqrt(1.0 - params["lam_cut"])
    cut_h, cut_w = (H * cut_rat).long(), (W * cut_rat).long()
    y1 = torch.clamp(params["cy"] - cut_h // 2, 0, H)
    y2 = torch.clamp(params["cy"] + cut_h // 2, 0, H)
    x1 = torch.clamp(params["cx"] - cut_w // 2, 0, W)
    x2 = torch.clamp(params["cx"] + cut_w // 2, 0, W)
    ys = torch.arange(H, device=video.device)[:, None]
    xs = torch.arange(W, device=video.device)[None, :]
    box = (ys >= y1) & (ys < y2) & (xs >= x1) & (xs < x2)
    cut = torch.where(box[None, None, :, :, None], flipped, video)
    lam_cut = 1.0 - ((y2 - y1) * (x2 - x1)) / (H * W)
    mixed = torch.where(params["use_cutmix"], cut, blend)
    lam = torch.where(params["use_cutmix"], lam_cut, lam_mix)
    targets = onehot * lam + onehot.flip(0) * (1.0 - lam)
    return (torch.where(params["use"], mixed, video),
            torch.where(params["use"], targets, onehot))


def mixup_cutmix(video, labels, generator, *, num_classes: int,
                 mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 switch_prob: float = 0.5, prob: float = 1.0,
                 label_smoothing: float = 0.1):
    params = draw_mixup_cutmix(video, generator, mixup_alpha=mixup_alpha,
                               cutmix_alpha=cutmix_alpha,
                               switch_prob=switch_prob, prob=prob)
    return apply_mixup_cutmix(video, labels, params, num_classes=num_classes,
                              label_smoothing=label_smoothing)


def train_augment_cls(video_u8, labels, generator, *, crop_size: int = 224,
                      num_classes: int = 400, reprob: float = 0.25,
                      mixup: float = 0.8, cutmix: float = 1.0,
                      switch_prob: float = 0.5, smoothing: float = 0.1,
                      dtype=torch.float32):
    """The class fine-tuning augmentation (the JAX CLI's
    train_augment_cls): (B, T, H, W, C) uint8 clips and (B,) labels on the
    device -> the (B, T, crop, crop, C) video in ``dtype`` and (B,
    num_classes) fp32 soft targets.  RandomResizedCrop -> flip -> full
    RandAugment -> /255 + ImageNet normalize -> RandomErasing (``reprob``
    > 0) -> mixup / cutmix (either alpha > 0; else one-hot targets)."""
    x = video_u8.float()
    x = random_resized_crop(x, generator, crop_size)
    x = random_hflip(x, generator)
    x = rand_augment_full(x, generator)
    x = normalize(x)
    if reprob > 0:
        x = random_erasing(x, generator, probability=reprob)
    if mixup > 0 or cutmix > 0:
        x, targets = mixup_cutmix(x, labels, generator,
                                  num_classes=num_classes,
                                  mixup_alpha=mixup, cutmix_alpha=cutmix,
                                  switch_prob=switch_prob,
                                  label_smoothing=smoothing)
    else:
        targets = F.one_hot(labels.long(), num_classes).float()
    return x.to(dtype), targets
