"""Prediction visualization and MAE reconstruction images, in the port.

Port of simple_tad_tpu/cli/visualize.py (reference: anaysis/
vis_video_paper.py, data_tools/zip2gif.py, vis.sh / run_videomae_vis.py):
risk-curve overlays on a clip's frames, zip -> GIF export, the
multi-model paper figure, and ``mae-recon``, the masked-autoencoder
reconstruction strips that jobs/vis.sh writes.

``mae-recon`` is split into a reader and a core.  ``reconstruct`` (the
core) takes the clip as a (T, H, W, 3) uint8 RGB array and returns the
orig / masked / recon arrays; it imports no cv2, so the CPU tests and the
card's smoke run call it on frames from memory.  Frames not at the model's
size are resized by the port's cubic resize (ops/image.py, which follows
cv2's INTER_CUBIC).  The model runs in fp32 (the JAX function's dtype) on
``--device`` (default cuda): on the card its attention and LayerNorms are
the port's fp32 kernels.  ``mae_reconstruction`` wraps the core with the
frame reader (a video file, an images.zip or a folder of JPEGs; cv2) and
the JPEG writer.  The predictions of the masked patches are un-normalised
with each original patch's mean and unbiased std (the training target is
per-patch normalised, engine_for_pretraining.py:201-217).

cv2, PIL (GIFs) and matplotlib (the paper figure) are imported by the
functions that need them.  predictions.csv is read with the csv module.

Usage:
  python -m simple_tad_tpu_torch.cli.visualize overlay \\
      --data_path <dota_root> --preds out/predictions.csv \\
      --clip <clip_name> --out vis/
  python -m simple_tad_tpu_torch.cli.visualize zip2gif \\
      --zip frames/<clip>/images.zip --out clip.gif [--fps 10]
  python -m simple_tad_tpu_torch.cli.visualize paper-figure \\
      --data_path <dota_root> --clip <clip_name> --out fig.png \\
      --preds a/predictions.csv --name "w/o DAPT" \\
      --preds b/predictions.csv --name "w/ DAPT"
  python -m simple_tad_tpu_torch.cli.visualize mae-recon \\
      --model pretrain_videomae_base_patch16_224 \\
      --mask_ratio 0.9 --mask_type tube --decoder_depth 4 \\
      --ckpt videomae_b_pretrain.pth --video demo.mp4 --output_dir vis/
"""

from __future__ import annotations

import argparse
import csv
import os
import zipfile
from typing import Dict, List, Optional

import numpy as np
import torch


def annotate_frame(img: np.ndarray, risk: float, label: Optional[int],
                   history: List[float], max_history: int = 100
                   ) -> np.ndarray:
    """Draw a risk bar + scrolling risk curve on one BGR frame."""
    import cv2
    h, w = img.shape[:2]
    out = img.copy()
    # risk bar
    bar_w = int(w * 0.25)
    x0, y0 = 10, 10
    cv2.rectangle(out, (x0, y0), (x0 + bar_w, y0 + 16), (60, 60, 60), -1)
    fill = int(bar_w * min(max(risk, 0.0), 1.0))
    color = (0, 0, 255) if risk > 0.5 else (0, 200, 0)
    cv2.rectangle(out, (x0, y0), (x0 + fill, y0 + 16), color, -1)
    cv2.putText(out, f"risk {risk:.2f}", (x0 + bar_w + 8, y0 + 14),
                cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
    if label is not None:
        txt = "ANOMALY" if label else "normal"
        cv2.putText(out, txt, (x0, y0 + 36), cv2.FONT_HERSHEY_SIMPLEX,
                    0.55, (0, 0, 255) if label else (0, 200, 0), 2)
    # scrolling curve along the bottom
    hist = history[-max_history:]
    if len(hist) > 1:
        base = h - 12
        span = int(h * 0.2)
        pts = [(int(w * i / max_history),
                int(base - v * span)) for i, v in enumerate(hist)]
        cv2.polylines(out, [np.asarray(pts, np.int32)], False,
                      (0, 255, 255), 1)
        cv2.line(out, (0, int(base - 0.5 * span)),
                 (int(w * len(hist) / max_history),
                  int(base - 0.5 * span)), (120, 120, 120), 1)
    return out


def read_clip_predictions(preds_csv: str, clip: str) -> Dict[str, list]:
    """The rows of ``clip`` in a predictions.csv, in file order ->
    {'filename': [str], 'risk': [softmax risk], 'label': [int]}."""
    names, logits, labels = [], [], []
    with open(preds_csv, newline="") as f:
        for row in csv.DictReader(f):
            if row["clip"] != clip:
                continue
            names.append(row["filename"])
            logits.append((float(row["logits_safe"]),
                           float(row["logits_risk"])))
            labels.append(int(float(row["label"])))
    if not names:
        raise ValueError(f"no predictions for clip {clip!r} in {preds_csv}")
    lg = np.asarray(logits, np.float64)
    e = np.exp(lg - lg.max(axis=1, keepdims=True))
    risk = (e / e.sum(axis=1, keepdims=True))[:, 1]
    return {"filename": names, "risk": list(risk), "label": labels}


def overlay_clip(data_path: str, preds_csv: str, clip: str, out_dir: str,
                 gif: Optional[str] = None, fps: int = 10) -> int:
    import cv2
    preds = read_clip_predictions(preds_csv, clip)
    risk_of = dict(zip(preds["filename"], preds["risk"]))
    label_of = dict(zip(preds["filename"], preds["label"]))

    os.makedirs(out_dir, exist_ok=True)
    zpath = os.path.join(data_path, "frames", clip, "images.zip")
    written = 0
    history: List[float] = []
    gif_frames = []
    with zipfile.ZipFile(zpath) as zf:
        for name in sorted(zf.namelist()):
            if name not in risk_of:
                continue
            img = cv2.imdecode(np.frombuffer(zf.read(name), np.uint8),
                               cv2.IMREAD_COLOR)
            history.append(float(risk_of[name]))
            out = annotate_frame(img, history[-1],
                                 int(label_of[name]), history)
            cv2.imwrite(os.path.join(out_dir, name), out)
            if gif is not None:
                gif_frames.append(cv2.cvtColor(out, cv2.COLOR_BGR2RGB))
            written += 1
    if gif is not None and gif_frames:
        _write_gif(gif_frames, gif, fps)
    return written


def _write_gif(rgb_frames: List[np.ndarray], out: str, fps: int = 10):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("writing a GIF needs Pillow (PIL)") from e
    ims = [Image.fromarray(f) for f in rgb_frames]
    ims[0].save(out, save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=0)


def zip2gif(zip_path: str, out: str, fps: int = 10, scale: float = 0.5,
            max_frames: int = 200) -> int:
    """data_tools/zip2gif.py equivalent."""
    import cv2
    frames = []
    with zipfile.ZipFile(zip_path) as zf:
        for name in sorted(zf.namelist())[:max_frames]:
            img = cv2.imdecode(np.frombuffer(zf.read(name), np.uint8),
                               cv2.IMREAD_COLOR)
            if img is None:
                continue
            if scale != 1.0:
                img = cv2.resize(img, (0, 0), fx=scale, fy=scale)
            frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    if frames:
        _write_gif(frames, out, fps)
    return len(frames)


def _glue_with_margin(imgs: List[np.ndarray], timestamps: List[float],
                      margin: int = 3) -> np.ndarray:
    """Horizontally glue BGR frames with white gaps, stamping each with its
    timestamp (orange text over a black outline, bottom-right) — the
    reference's glue_with_margin (anaysis/vis_video_paper.py:60-101)."""
    import cv2
    annotated = []
    for img, ts in zip(imgs, timestamps):
        img = img.copy()
        h, w = img.shape[:2]
        text = f"{ts:.1f} s"
        scale = max(w / 400.0, 0.5)
        thick = max(int(round(scale * 1.5)), 1)
        (tw, th), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX,
                                      scale, thick)
        x, y = w - tw - max(w // 20, 6), h - max(h // 20, 6)
        cv2.putText(img, text, (x, y), cv2.FONT_HERSHEY_SIMPLEX, scale,
                    (0, 0, 0), thick + 2, cv2.LINE_AA)
        cv2.putText(img, text, (x, y), cv2.FONT_HERSHEY_SIMPLEX, scale,
                    (0, 165, 255), thick, cv2.LINE_AA)
        annotated.append(img)
    gap = np.full((annotated[0].shape[0], margin, 3), 255,
                  annotated[0].dtype)
    rows: List[np.ndarray] = []
    for im in annotated:
        rows.extend([im, gap])
    return np.hstack(rows[:-1])


def paper_figure(preds_csvs: List[str], names: List[str], clip: str,
                 data_path: str, out: str, *, frame_times: Optional[
                     List[float]] = None, n_frames: int = 4,
                 fps: float = 10.0) -> str:
    """Multi-model qualitative comparison figure
    (anaysis/vis_video_paper.py:40-253): a strip of timestamped frames from
    the clip on top, every model's softmax risk curve below with the
    ground-truth anomaly window shaded and the 0.5 threshold dashed.

    ``preds_csvs``/``names``: one predictions.csv + legend label per model
    (all scored on the same clip — labels must agree).  ``frame_times``:
    seconds into the clip for the strip frames (default: evenly spaced).
    Output format follows the ``out`` extension (png/pdf).  Needs
    matplotlib."""
    import cv2
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("paper-figure needs matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.gridspec as gridspec
    import matplotlib.pyplot as plt

    assert len(preds_csvs) == len(names) and preds_csvs, \
        "one --name per --preds"
    curves, labels_ref = [], None
    for path in preds_csvs:
        preds = read_clip_predictions(path, clip)
        order = sorted(range(len(preds["filename"])),
                       key=lambda i: preds["filename"][i])
        curves.append(np.asarray([preds["risk"][i] for i in order]))
        labels = np.asarray([preds["label"][i] for i in order]).astype(bool)
        if labels_ref is None:
            labels_ref = labels
            frame_names = [preds["filename"][i] for i in order]
        else:
            assert len(labels) == len(labels_ref) and (
                labels == labels_ref).all(), \
                f"labels mismatch between {preds_csvs[0]} and {path}"
    T = len(labels_ref)
    time = np.arange(T) / fps

    if frame_times is None:
        frame_times = list(np.linspace(time[0], time[-1],
                                       min(n_frames, T)))
    zpath = os.path.join(data_path, "frames", clip, "images.zip")
    imgs = []
    with zipfile.ZipFile(zpath) as zf:
        for ts in frame_times:
            name = frame_names[min(int(round(ts * fps)), T - 1)]
            imgs.append(cv2.imdecode(np.frombuffer(zf.read(name), np.uint8),
                                     cv2.IMREAD_COLOR))
    glued = _glue_with_margin(imgs, frame_times)

    fig = plt.figure(figsize=(15, 3.7))
    gs = gridspec.GridSpec(2, 1, height_ratios=[3, 2], hspace=0.05)
    ax_img = fig.add_subplot(gs[0, 0])
    ax_img.imshow(cv2.cvtColor(glued, cv2.COLOR_BGR2RGB))
    ax_img.axis("off")

    ax = fig.add_subplot(gs[1, 0])
    palette = ["#8F1A55", "#1A788F", "#1A8F3C", "#8F6B1A", "#4B1A8F"]
    for i, (curve, name) in enumerate(zip(curves, names)):
        ax.plot(time, curve, label=name,
                color=palette[i % len(palette)], lw=2)
    ax.fill_between(time, 0.0, 1.0, where=labels_ref, color="#9B398A",
                    alpha=0.3, transform=ax.get_xaxis_transform())
    ax.axhline(0.5, color="gray", linestyle="--", linewidth=1.5, zorder=1)
    anom = time[labels_ref]
    if anom.size:
        ax.text((anom.min() + anom.max()) / 2, 0.52,
                "ground truth\nanomaly window", ha="center", va="bottom",
                fontsize=10, color="#353535")
    ax.set_xlim(time[0], time[-1])
    ax.set_ylim(-0.015, 1.02)
    ax.set_xlabel("Time (s)", fontsize=12)
    ax.set_ylabel("Risk score", fontsize=14)
    ax.legend(loc="upper left", frameon=False, fontsize=12)
    fig.savefig(out, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return out


# ------------------------------------------------------- MAE reconstruction

def _read_clip_frames(path: str, n: int, stride: int) -> List[np.ndarray]:
    """First window of ``n`` frames at ``stride`` from a video file, an
    images.zip, or a directory of JPEGs — BGR uint8."""
    import cv2
    idx = [i * stride for i in range(n)]
    frames: List[np.ndarray] = []
    if os.path.isdir(path):
        names = sorted(os.listdir(path))
        for i in idx:
            frames.append(cv2.imread(os.path.join(
                path, names[min(i, len(names) - 1)])))
    elif path.endswith(".zip"):
        with zipfile.ZipFile(path) as zf:
            names = sorted(zf.namelist())
            for i in idx:
                frames.append(cv2.imdecode(
                    np.frombuffer(zf.read(names[min(i, len(names) - 1)]),
                                  np.uint8), cv2.IMREAD_COLOR))
    else:
        cap = cv2.VideoCapture(path)
        buf = []
        while len(buf) <= idx[-1]:
            ok, img = cap.read()
            if not ok:
                break
            buf.append(img)
        cap.release()
        if not buf:
            raise IOError(f"no frames decoded from {path}")
        frames = [buf[min(i, len(buf) - 1)] for i in idx]
    return frames


def build_mae_model(model_name: str, ckpt: str = "", *,
                    decoder_depth: int = 4, num_frames: int = 16,
                    input_size: int = 224, device="cuda", seed: int = 0):
    """The fp32 pre-training model of ``mae-recon`` on ``device``: weights
    from ``ckpt`` (a reference pre-training .pth) or, without one, seeded
    from ``seed``."""
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.utils.torch_convert import load_checkpoint_auto
    model = create_model(model_name, device=torch.device(device),
                         generator=torch.Generator().manual_seed(seed),
                         decoder_depth=decoder_depth, all_frames=num_frames,
                         img_size=input_size, dtype=torch.float32)
    if ckpt:
        load_checkpoint_auto(ckpt, model)
    return model


def patchify(video: np.ndarray, patch: int, tubelet: int) -> np.ndarray:
    """(T, H, W, 3) -> (tokens, tubelet * patch * patch, 3), tokens in the
    model's (t, h, w) order."""
    T, H, W, C = video.shape
    nt, nh, nw = T // tubelet, H // patch, W // patch
    v = video.reshape(nt, tubelet, nh, patch, nw, patch, C)
    return v.transpose(0, 2, 4, 1, 3, 5, 6).reshape(
        nt * nh * nw, tubelet * patch * patch, C)


def unpatchify(patches: np.ndarray, shape, patch: int, tubelet: int
               ) -> np.ndarray:
    """Inverse of ``patchify`` -> (T, H, W, 3) of ``shape``."""
    T, H, W, C = shape
    nt, nh, nw = T // tubelet, H // patch, W // patch
    u = patches.reshape(nt, nh, nw, tubelet, patch, patch, C)
    return u.transpose(0, 3, 1, 4, 2, 5, 6).reshape(T, H, W, C)


def reconstruct(model, frames: np.ndarray, *, mask_ratio: float = 0.9,
                seed: int = 42) -> Dict[str, np.ndarray]:
    """The core of ``mae-recon``: ``frames`` (T, H, W, 3) uint8 RGB, T the
    model's frame count -> {'orig', 'masked', 'recon': (T, S, S, 3) fp32 in
    [0, 1] units, unclipped; 'pred': (masked tokens, tubelet * p * p * 3)
    the model's normalised predictions; 'mask_idx': their token indices}.
    A tube mask from np.random.default_rng(seed); masked patches are grey
    (0.5) in 'masked' and predicted in 'recon'."""
    from simple_tad_tpu_torch.data.masking import TubeMaskingGenerator
    from simple_tad_tpu_torch.models.mae import mask_partition
    from simple_tad_tpu_torch.ops.image import (IMAGENET_MEAN, IMAGENET_STD,
                                                resize_bicubic)
    cfg = model.cfg
    S, p, tb = cfg.img_size, cfg.patch_size, cfg.tubelet_size
    device = next(model.parameters()).device
    if frames.shape[1:3] != (S, S):
        frames = resize_bicubic(torch.from_numpy(frames), (S, S)).round_(
            ).to(torch.uint8).numpy()
    unnorm = frames.astype(np.float32) / 255.0               # (T, S, S, 3)
    x = (unnorm - IMAGENET_MEAN) / IMAGENET_STD
    T = unnorm.shape[0]
    gen = TubeMaskingGenerator((T // tb, S // p, S // p), mask_ratio)
    mask = torch.from_numpy(
        gen(np.random.default_rng(seed)).astype(bool)[None])   # (1, N)
    num_masked = int(mask.sum())
    with torch.inference_mode():
        pred = model(torch.from_numpy(x[None]).to(device), mask.to(device),
                     num_masked)
    pred = pred[0].float().cpu().numpy()
    _, midx = mask_partition(mask, num_masked)
    midx = midx[0].numpy()

    v = patchify(unnorm, p, tb)
    mu = v.mean(axis=1, keepdims=True)
    var = ((v - mu) ** 2).sum(axis=1, keepdims=True) / (v.shape[1] - 1)
    sd = np.sqrt(var) + 1e-6
    rec = v.copy()
    rec[midx] = pred.reshape(num_masked, -1, 3) * sd[midx] + mu[midx]
    masked = v.copy()
    masked[midx] = 0.5                            # grey out masked tubelets
    return {"orig": unnorm, "masked": unpatchify(masked, unnorm.shape, p, tb),
            "recon": unpatchify(rec, unnorm.shape, p, tb), "pred": pred,
            "mask_idx": midx}


def write_strips(arrays: Dict[str, np.ndarray], out_dir: str) -> None:
    """orig_<t>.jpg, masked_<t>.jpg, recon_<t>.jpg for every frame t."""
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    for name in ("orig", "masked", "recon"):
        strip = (np.clip(arrays[name], 0, 1) * 255).astype(np.uint8)
        for t in range(strip.shape[0]):
            cv2.imwrite(os.path.join(out_dir, f"{name}_{t:02d}.jpg"),
                        cv2.cvtColor(strip[t], cv2.COLOR_RGB2BGR))


def mae_reconstruction(model_name: str, ckpt: str, video: str, out_dir: str,
                       *, mask_ratio: float = 0.9, decoder_depth: int = 4,
                       num_frames: int = 16, sampling_rate: int = 4,
                       input_size: int = 224, seed: int = 42,
                       device="cuda") -> str:
    """Masked-autoencoder reconstruction images (the reference vis.sh /
    run_videomae_vis.py workflow): read one clip window (cv2, resized to
    the model's size with INTER_CUBIC), ``reconstruct`` it, and write the
    orig / masked / recon frame strips.  Without ``ckpt`` the weights are
    seeded (seed 0)."""
    import cv2
    model = build_mae_model(model_name, ckpt, decoder_depth=decoder_depth,
                            num_frames=num_frames, input_size=input_size,
                            device=device)
    bgr = _read_clip_frames(video, num_frames, sampling_rate)
    rgb = np.stack([cv2.cvtColor(cv2.resize(
        f, (input_size, input_size), interpolation=cv2.INTER_CUBIC),
        cv2.COLOR_BGR2RGB) for f in bgr])
    write_strips(reconstruct(model, rgb, mask_ratio=mask_ratio, seed=seed),
                 out_dir)
    return out_dir


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("simple_tad_tpu_torch visualization")
    sub = p.add_subparsers(dest="cmd", required=True)
    o = sub.add_parser("overlay")
    o.add_argument("--data_path", required=True)
    o.add_argument("--preds", required=True)
    o.add_argument("--clip", required=True)
    o.add_argument("--out", required=True)
    o.add_argument("--gif", default=None)
    o.add_argument("--fps", type=int, default=10)
    g = sub.add_parser("zip2gif")
    g.add_argument("--zip", required=True)
    g.add_argument("--out", required=True)
    g.add_argument("--fps", type=int, default=10)
    g.add_argument("--scale", type=float, default=0.5)
    pf = sub.add_parser("paper-figure",
                        help="multi-model comparison figure "
                             "(anaysis/vis_video_paper.py)")
    pf.add_argument("--data_path", required=True)
    pf.add_argument("--preds", action="append", required=True,
                    help="predictions.csv (repeat per model)")
    pf.add_argument("--name", action="append", required=True,
                    help="legend label (repeat per model, paired with "
                         "--preds)")
    pf.add_argument("--clip", required=True)
    pf.add_argument("--out", required=True, help="output .png / .pdf")
    pf.add_argument("--frame_times", type=float, nargs="*", default=None,
                    help="seconds into the clip for the strip frames")
    pf.add_argument("--n_frames", type=int, default=4)
    pf.add_argument("--fps", type=float, default=10.0)
    m = sub.add_parser("mae-recon",
                       help="MAE reconstruction strips (reference vis.sh)")
    m.add_argument("--model", default="pretrain_videomae_base_patch16_224")
    m.add_argument("--ckpt", default="")
    m.add_argument("--video", required=True)
    m.add_argument("--output_dir", required=True)
    m.add_argument("--mask_ratio", type=float, default=0.9)
    m.add_argument("--mask_type", default="tube", choices=["tube"])
    m.add_argument("--decoder_depth", type=int, default=4)
    m.add_argument("--num_frames", type=int, default=16)
    m.add_argument("--sampling_rate", type=int, default=4)
    m.add_argument("--input_size", type=int, default=224)
    m.add_argument("--seed", type=int, default=42,
                   help="the tube mask's seed")
    m.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "overlay":
        n = overlay_clip(args.data_path, args.preds, args.clip, args.out,
                         gif=args.gif, fps=args.fps)
        print(f"annotated {n} frames -> {args.out}")
    elif args.cmd == "zip2gif":
        n = zip2gif(args.zip, args.out, args.fps, args.scale)
        print(f"wrote {n} frames -> {args.out}")
    elif args.cmd == "paper-figure":
        out = paper_figure(args.preds, args.name, args.clip, args.data_path,
                           args.out, frame_times=args.frame_times,
                           n_frames=args.n_frames, fps=args.fps)
        print(f"wrote figure -> {out}")
    elif args.cmd == "mae-recon":
        out = mae_reconstruction(
            args.model, args.ckpt, args.video, args.output_dir,
            mask_ratio=args.mask_ratio, decoder_depth=args.decoder_depth,
            num_frames=args.num_frames, sampling_rate=args.sampling_rate,
            input_size=args.input_size, seed=args.seed, device=args.device)
        print(f"wrote reconstruction strips -> {out}")


if __name__ == "__main__":
    main()
