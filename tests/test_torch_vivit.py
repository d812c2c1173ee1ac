"""The port's HuggingFace ViViT converter (utils/torch_convert.py:
convert_vivit_state_dict) against the JAX package's, after
tests/test_diagnostics.py:75: on a synthetic HF-ViViT dict the two
outputs are equal (the q/k/v merge, renames and CLS drop exactly; the
trilinear 16 -> 8 interpolation of the table exactly, both run torch's),
and a port ViT (``use_learnable_pos_emb=True``) loaded from the converted
``.pth`` gives the JAX ViT's logits on the same dict within 1e-4 at fp32
(ROADMAP.md's slice gate).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from simple_tad_tpu.models.vit import ViTConfig as JaxViTConfig
from simple_tad_tpu.models.vit import VisionTransformer as JaxViT
from simple_tad_tpu.utils import torch_convert as jax_tc
from simple_tad_tpu_torch.models.vit import ViTConfig, VisionTransformer
from simple_tad_tpu_torch.utils import torch_convert as tc
from tests.test_torch_vit import (  # noqa: F401
    drop_checkpoints, one_torch_thread)

DEPTH, DIM, HEADS, CLASSES = 2, 64, 2, 3


def _hf_dict(seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*s):
        return torch.randn(*s, generator=g) * 0.05

    hf = {
        "embeddings.patch_embeddings.projection.weight": r(DIM, 3, 2, 16, 16),
        "embeddings.patch_embeddings.projection.bias": r(DIM),
        "embeddings.cls_token": r(1, 1, DIM),
        "embeddings.position_embeddings": r(1, 16 * 4 + 1, DIM),
        "layernorm.weight": 1 + r(DIM),
        "layernorm.bias": r(DIM),
    }
    for i in range(DEPTH):
        pre = f"encoder.layer.{i}."
        att = pre + "attention.attention."
        hf.update({
            f"{pre}layernorm_before.weight": 1 + r(DIM),
            f"{pre}layernorm_before.bias": r(DIM),
            f"{att}query.weight": r(DIM, DIM),
            f"{att}query.bias": r(DIM),
            f"{att}key.weight": r(DIM, DIM),
            f"{att}key.bias": torch.zeros(DIM),
            f"{att}value.weight": r(DIM, DIM),
            f"{att}value.bias": r(DIM),
            f"{pre}attention.output.dense.weight": r(DIM, DIM),
            f"{pre}attention.output.dense.bias": r(DIM),
            f"{pre}layernorm_after.weight": 1 + r(DIM),
            f"{pre}layernorm_after.bias": r(DIM),
            f"{pre}intermediate.dense.weight": r(4 * DIM, DIM),
            f"{pre}intermediate.dense.bias": r(4 * DIM),
            f"{pre}output.dense.weight": r(DIM, 4 * DIM),
            f"{pre}output.dense.bias": r(DIM),
        })
    return {k: v.numpy() for k, v in hf.items()}


def test_converter_matches_jax():
    hf = _hf_dict()
    got = tc.convert_vivit_state_dict(hf, depth=DEPTH, num_temp_vivit=16,
                                      num_temp_target=8)
    want = jax_tc.convert_vivit_state_dict(hf, depth=DEPTH,
                                           num_temp_vivit=16,
                                           num_temp_target=8)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["blocks.0.attn.qkv.weight"].shape == (3 * DIM, DIM)
    assert "blocks.0.attn.k_bias" not in got
    assert got["pos_embed"].shape == (1, 8 * 4, DIM)
    # torch tensors in, the same dict out
    again = tc.convert_vivit_state_dict(
        {k: torch.from_numpy(v) for k, v in hf.items()}, depth=DEPTH)
    for k in got:
        assert torch.equal(again[k], got[k]), k


def test_loaded_vit_matches_jax_logits(tmp_path):
    """The converted dict (with a 3-class head added) as a .pth, read by the
    port's load_vit_checkpoint and by the JAX package's
    torch_to_vit_params + merge_params: the same logits at fp32."""
    hf = _hf_dict(1)
    sd = tc.convert_vivit_state_dict(hf, depth=DEPTH)
    rng = np.random.default_rng(2)
    sd["head.weight"] = torch.from_numpy(
        rng.standard_normal((CLASSES, DIM)).astype(np.float32) * 0.1)
    sd["head.bias"] = torch.from_numpy(
        rng.standard_normal(CLASSES).astype(np.float32) * 0.1)
    path = str(tmp_path / "vivit.pth")
    torch.save({"model": sd}, path)

    geometry = dict(img_size=32, all_frames=16, embed_dim=DIM, depth=DEPTH,
                    num_heads=HEADS, num_classes=CLASSES,
                    use_learnable_pos_emb=True, final_reduction="fc_norm")
    model = VisionTransformer(ViTConfig(**geometry), device="cpu").eval()
    loaded = tc.load_vit_checkpoint(path, model)
    assert set(loaded) == set(model.state_dict())

    jm = JaxViT(JaxViTConfig(**geometry, attn_impl="naive"))
    params = jax_tc.merge_params(
        jm.init_params(jax.random.PRNGKey(0)),
        jax_tc.torch_to_vit_params({k: v.numpy() for k, v in sd.items()},
                                   depth=DEPTH, num_classes=CLASSES))
    x = np.random.default_rng(3).standard_normal(
        (2, 16, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, CLASSES)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
