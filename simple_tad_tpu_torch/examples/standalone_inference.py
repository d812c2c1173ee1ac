"""Self-contained single-clip anomaly inference in plain PyTorch: the
dependency-light correctness reference of the port.

Torch twin of examples/standalone_inference.py (reference:
run_inference_simple.py:279-475, which re-implements the ViT inline so the
model definition can be checked without the framework).  This file needs
only torch + numpy, and cv2 in ``main`` to read the frames.  It imports
nothing from either package: it restates the VideoMAE ViT forward (S/B/L)
in plain torch (the sincos position table, pre-LN blocks with packed qkv
and q/v biases, the exact GELU MLP, mean pooling, fc_norm and the head) and
prints the risk probability of one 16-frame window.  It reads a
reference-named ``.pth`` (``patch_embed.proj.weight``, ``blocks.<i>.*``,
``fc_norm.*``, ``head.*``; the port's exchange format), where the JAX file
reads an ``.npz``.  It is a readable reference, not a fast path: it
launches no hand-written kernel.

Usage:
  python simple_tad_tpu_torch/examples/standalone_inference.py \\
      --ckpt model.pth --frames_dir clip_frames/ [--arch small|base|large]
"""

import argparse
import glob
import os

import numpy as np
import torch
import torch.nn.functional as F

ARCHS = {"small": (384, 12, 6), "base": (768, 12, 12),
         "large": (1024, 24, 16)}
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_state_dict(path):
    """A reference .pth -> {name: fp32 tensor} ('model' / 'module'
    unwrapped)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model", "module"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    return {k: v.float() for k, v in sd.items()}


def sincos_table(n, d):
    pos = np.arange(n, dtype=np.float64)[:, None]
    j = np.arange(d, dtype=np.float64)[None, :]
    ang = pos / np.power(10000.0, 2.0 * np.floor(j / 2.0) / d)
    t = np.where(np.arange(d) % 2 == 0, np.sin(ang), np.cos(ang))
    return torch.from_numpy(t.astype(np.float32))


def vit_forward(sd, video, depth, heads):
    """video: (16, 224, 224, 3) normalized fp32 tensor -> (num_classes,)
    logits.  The VideoMAE ViT: tubelet 2 x 16 x 16 patches, pre-LN blocks
    (packed qkv, q/v biases, LayerScale where the checkpoint has it), mean
    pooling, fc_norm, head."""
    x = F.conv3d(video.permute(3, 0, 1, 2)[None], sd["patch_embed.proj.weight"],
                 sd["patch_embed.proj.bias"], stride=(2, 16, 16))
    x = x.flatten(2)[0].T                                   # (N, dim)
    x = x + sincos_table(x.shape[0], x.shape[1])

    dim = x.shape[1]
    hd = dim // heads
    for i in range(depth):
        def b(name):
            return sd[f"blocks.{i}.{name}"]
        gamma_1 = sd.get(f"blocks.{i}.gamma_1", 1.0)
        gamma_2 = sd.get(f"blocks.{i}.gamma_2", 1.0)
        h = F.layer_norm(x, (dim,), b("norm1.weight"), b("norm1.bias"), 1e-6)
        bias = torch.cat([b("attn.q_bias"), torch.zeros(dim),
                          b("attn.v_bias")])
        q, k, v = F.linear(h, b("attn.qkv.weight"), bias).split(dim, dim=-1)
        q, k, v = (t.reshape(-1, heads, hd).transpose(0, 1) for t in (q, k, v))
        attn = torch.softmax((q * hd ** -0.5) @ k.transpose(1, 2), dim=-1)
        o = (attn @ v).transpose(0, 1).reshape(-1, dim)
        x = x + gamma_1 * F.linear(o, b("attn.proj.weight"),
                                   b("attn.proj.bias"))
        h = F.layer_norm(x, (dim,), b("norm2.weight"), b("norm2.bias"), 1e-6)
        h = F.gelu(F.linear(h, b("mlp.fc1.weight"), b("mlp.fc1.bias")))
        x = x + gamma_2 * F.linear(h, b("mlp.fc2.weight"), b("mlp.fc2.bias"))

    pooled = F.layer_norm(x.mean(dim=0), (dim,), sd["fc_norm.weight"],
                          sd["fc_norm.bias"], 1e-6)
    return F.linear(pooled, sd["head.weight"], sd["head.bias"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="reference-named .pth")
    ap.add_argument("--frames_dir", required=True)
    ap.add_argument("--arch", default="small", choices=list(ARCHS))
    args = ap.parse_args()
    import cv2

    _dim, depth, heads = ARCHS[args.arch]
    sd = load_state_dict(args.ckpt)
    files = sorted(glob.glob(os.path.join(args.frames_dir, "*")))[:16]
    assert len(files) == 16, "need 16 frames"
    frames = []
    for f in files:
        img = cv2.imread(f, cv2.IMREAD_COLOR)
        img = cv2.resize(img, (224, 224), interpolation=cv2.INTER_CUBIC)
        frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    video = np.stack(frames).astype(np.float32) / 255.0
    video = (video - IMAGENET_MEAN) / IMAGENET_STD

    with torch.inference_mode():
        logits = vit_forward(sd, torch.from_numpy(video), depth, heads)
    probs = torch.softmax(logits, dim=-1)
    print(f"logits: {logits.numpy()}")
    print(f"risk probability: {float(probs[1]):.4f}")


if __name__ == "__main__":
    main()
