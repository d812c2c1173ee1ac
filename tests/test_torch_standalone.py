"""The port's standalone plain-torch reference
(simple_tad_tpu_torch/examples/standalone_inference.py) against the port's
ViT and the JAX standalone (examples/standalone_inference.py) on the same
weights, after tests/test_interop_vis.py: a 2-block, 64-wide ViT on one
16-frame window at 224, carried from the JAX tree into a reference-named
``.pth`` that the twin reads.  Logits and the risk within 1e-4 at fp32
(ROADMAP.md's slice gate); the twin's ``main`` prints the risk of a
folder of 16 frames equal to the port's ViT's on the same frames.
"""

import os
import sys

import cv2
import numpy as np
import torch

import jax
import jax.numpy as jnp

from simple_tad_tpu.models.vit import ViTConfig as JaxViTConfig
from simple_tad_tpu.models.vit import VisionTransformer as JaxViT
from simple_tad_tpu_torch.examples import standalone_inference as twin
from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = dict(img_size=224, all_frames=16, embed_dim=64, depth=2,
                num_heads=2, num_classes=2)


def _jax_standalone():
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import standalone_inference
    finally:
        sys.path.pop(0)
    return standalone_inference


def _weights(tmp_path, init_values=0.0):
    jm = JaxViT(JaxViTConfig(**GEOMETRY, init_values=init_values,
                             attn_impl="naive"))
    params = jm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params)
    path = str(tmp_path / "vit.pth")
    torch.save({"model": tc.from_jax_params(params)}, path)
    return jm, params, path


def _port_vit(path, init_values=0.0):
    model = VisionTransformer(ViTConfig(**GEOMETRY, init_values=init_values),
                              device="cpu").eval()
    tc.load_vit_checkpoint(path, model)
    return model


def test_twin_matches_port_vit_and_jax_standalone(tmp_path):
    jm, params, path = _weights(tmp_path)
    video = np.random.default_rng(0).normal(
        size=(16, 224, 224, 3)).astype(np.float32)
    sd = twin.load_state_dict(path)
    with torch.inference_mode():
        got = twin.vit_forward(sd, torch.from_numpy(video), depth=2,
                               heads=2).numpy()
        port = _port_vit(path)(torch.from_numpy(video)[None])[0].numpy()
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(node)
    walk("", params)
    jax_twin = np.asarray(_jax_standalone().vit_forward(
        flat, jnp.asarray(video), depth=2, heads=2))
    framework = np.asarray(jm.apply({"params": params},
                                    jnp.asarray(video)[None]))[0]
    assert got.shape == (2,)
    for want in (port, jax_twin, framework):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    risk = torch.softmax(torch.from_numpy(got), 0)[1]
    np.testing.assert_allclose(
        float(risk), float(jax.nn.softmax(jax_twin)[1]), atol=1e-4)


def test_twin_applies_layer_scale(tmp_path):
    _, _, path = _weights(tmp_path, init_values=0.1)
    video = np.random.default_rng(2).normal(
        size=(16, 224, 224, 3)).astype(np.float32)
    with torch.inference_mode():
        got = twin.vit_forward(twin.load_state_dict(path),
                               torch.from_numpy(video), depth=2, heads=2)
        want = _port_vit(path, 0.1)(torch.from_numpy(video)[None])[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)


def test_main_prints_the_risk(tmp_path, monkeypatch, capsys):
    _, _, path = _weights(tmp_path)
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(3)
    for t in range(16):
        cv2.imwrite(str(frames / f"{t:04d}.jpg"),
                    rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
    monkeypatch.setattr(sys, "argv", ["standalone_inference.py", "--ckpt",
                                      path, "--frames_dir", str(frames)])
    monkeypatch.setattr(twin, "ARCHS", {"small": (64, 2, 2)})
    twin.main()
    out = capsys.readouterr().out
    risk = float(out.strip().splitlines()[-1].split(":")[1])
    clip = np.stack([cv2.cvtColor(cv2.resize(
        cv2.imread(str(frames / f"{t:04d}.jpg")), (224, 224),
        interpolation=cv2.INTER_CUBIC), cv2.COLOR_BGR2RGB)
        for t in range(16)]).astype(np.float32) / 255.0
    clip = (clip - twin.IMAGENET_MEAN) / twin.IMAGENET_STD
    with torch.inference_mode():
        logits = _port_vit(path)(torch.from_numpy(clip)[None])[0]
    assert abs(risk - float(torch.softmax(logits, 0)[1])) <= 1e-4
